// Hand-written Hopper (sm_90a) kernel for chained VCGRA requests.
//
// Replaces the Pallas TPU megakernel vcgra_pipeline_batched of the JAX
// reference package (src/repro/kernels/vcgra/vcgra_kernel.py, body
// _pipeline_batched_body): N tenants, each running a depth-S chain of
// applications on its own raw frame, in ONE launch.  Stage i's forwarded
// output feeds stage i+1's tap bank; the last stage writes K outputs.
//
// What bounds it on the H100: instruction issue, not bytes.  The chain
// keeps its intermediates in shared memory, so each frame pixel crosses
// HBM once per chain (plus the tile halo) and each output once: at the
// chain shape (8 x 2048 x 2048 int32, K = 1) that is 0.08 ms of bytes.
// What is left is every PE of every stage at every pixel, each a
// runtime-selected op on two runtime-selected values, so the design
// spends its instructions on PEs:
//
//   * P pixels a thread.  A thread carries P = 16 / sizeof(T) neighbouring
//     pixels of a row (4 for int32 and float32, 8 for int16 and bf16)
//     through every PE: one settings read, one opcode dispatch and two
//     16-byte value reads serve P pixels.  Value columns are 16-byte
//     vectors, vals[slot][thread], read and written conflict-free.
//   * Settings decoded once per (stage, app), by a first launch
//     (vcgra_pipeline_settings, one warp each) into a record the main
//     kernel copies to shared memory before the stage.  The warp walks the
//     app's levels back from the outputs the stage needs (the last stage's
//     K, else the forwarded channel) and keeps only the live PEs, those an
//     output depends on, each packed as its opcode and both selects
//     (pre-multiplied by the column stride) in one word beside its
//     destination, and only the live input channels, in three lists: taps
//     (a buffer offset dy * row + dx: one 16-byte read where aligned, else
//     two and a shift for 4-byte dtypes, P scalar reads for 2-byte ones),
//     consts and zeros.  A dead PE's value never reaches a result, so
//     skipping it changes no output bit; on the pipe-shared grid gauss3
//     keeps 26 of 32 PEs, sobel_x 21, threshold 6 (B5 drops dead PEs the
//     same way, at compile time).
//   * The main loop evaluates PEs at one call site of pe_vec, the next
//     PE's operands and the following one's settings loaded while one
//     computes, and fetches taps two at a time and the frame window eight
//     loads a thread at a time, so that reads overlap.  No division or
//     modulo runs per pixel: threads walk the region's (row, group) pairs
//     by adding a precomputed step.
//   * The trapezoid.  One block per (app, 32-row x 32P-column output
//     tile: 32 x 128 for 32-bit grids, 32 x 256 for 16-bit).  It loads the
//     (32 + 2R) x (32P + 2R) window of the frame into shared memory once,
//     R = sum of the stage radii; taps outside [0,H) x [0,W) read 0.  Stage
//     i computes the tile grown by reach_i = sum of the radii after i, in
//     whole P-pixel groups, from the previous stage's region, into the
//     second (ping-pong) region buffer.  Every region buffer shares the
//     window's coordinates (buffer column c is global column tx0 - P - Rp
//     + c, Rp = R rounded up to P), so groups are 16-byte aligned in every
//     stage; the columns a group computes beyond its region are never read
//     by a pixel that is kept.  The halo costs ~8% more pixels than the
//     tile at R = 3.
//   * Masking, which makes the chain bitwise equal to the staged oracle:
//     after every non-final stage a forwarded value whose global position
//     lies outside the app's [0,h) x [0,w) (from hw) is set to 0, halo
//     pixels outside the canvas included (h <= H, w <= W).  The last stage
//     is not masked; the caller slices.
//   * Forwarding follows the oracle (interpreter.forward_stage_output):
//     stage i forwards its OUTPUT channel out_ch, i.e. the last level's
//     slot out_sel[out_ch] -- not slot out_ch as the Pallas body does.
//   * Value columns ping-pong between two banks: bank A holds the C input
//     channels and the outputs of levels 1, 3, ...; bank B those of levels
//     0, 2, ... (slots_a = max(C, widths of odd levels), slots_b = max of
//     the even ones), so the pipe-shared grid (C 19, levels 11 7 5 4 3 2)
//     keeps 30 slots a thread, not 2 x 19.
//   * Dynamic shared memory (smem_layout): two region buffers of (32 + 2R)
//     x (32P + 2Rp + 2P) elements, (slots_a + slots_b) x threads x 16
//     bytes of value columns, and the stage's settings record.  The int32
//     depth-3 chain on pipe-shared takes 106 KB at 128 threads: two blocks
//     (8 warps) an SM.  The wrapper (ops.pipeline_launch) picks the most
//     threads of 128, 64, 32 that fit the 232,448 bytes a block may take;
//     at the limits (R = 16, 64 + 64 slots) 64 threads take ~215 KB.  R >
//     16 or a value vector wider than 64 is refused.
//   * PE semantics are B1's (vcgra_pe.cuh): pe_vec applies the scalar
//     pe(...) overloads lane by lane with the opcode a constant, so the
//     vector PE is bitwise the scalar one (integer DIV by a positive power
//     of two as the arithmetic shift it equals; floor DIV with a guarded
//     divisor, wrapping int16, __f*_rn float ops under --fmad=false,
//     NaN-propagating MAX/MIN, bf16 rounded after every PE).  Radius-0
//     stages take a 1-tap bank.  64-bit index math for N*K*H*W.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or the error of the shared-memory
// attribute call).

#include "vcgra_pe.cuh"

namespace {

constexpr int kTileRows = 32;        // output tile rows; columns are 32 P
constexpr int kMaxVals = 64;         // widest value vector: max(C, pes per level)
constexpr int kMaxTotalRadius = 16;  // largest sum of stage radii
constexpr int kMaxSmem = 232448;     // shared memory a block may take
// Channel kinds, staged per stage.
constexpr int kTap = 0, kConst = 1, kZero = 2;
constexpr unsigned FULL_LANES = 0xffffffffu;

// P pixels of one grid dtype: 16 bytes, one shared-memory vector access.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
  T v[N];
};

template <int OP, typename T>
__device__ __forceinline__ Vec<T> pe_lanes(const Vec<T>& a, const Vec<T>& b) {
  Vec<T> r;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) r.v[i] = pe(OP, a.v[i], b.v[i]);
  return r;
}

template <typename T>
__device__ __forceinline__ Vec<T> zero_vec() {
  Vec<T> r;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) r.v[i] = zero_value<T>();
  return r;
}

// Integer DIV by a positive power of two is an arithmetic shift, which is
// floor division exactly (gauss3 divides by 16); any other divisor takes
// pe(DIV, ...).  Float DIV stays pe's IEEE division.
template <typename T>
__device__ __forceinline__ T div_lane(T a, T b) {
  return pe(DIV, a, b);
}
template <>
__device__ __forceinline__ int32_t div_lane<int32_t>(int32_t a, int32_t b) {
  return b > 0 && (b & (b - 1)) == 0 ? a >> (__ffs(b) - 1) : pe(DIV, a, b);
}
template <>
__device__ __forceinline__ int16_t div_lane<int16_t>(int16_t a, int16_t b) {
  return b > 0 && (b & (b - 1)) == 0 ? static_cast<int16_t>(a >> (__ffs(b) - 1))
                                     : pe(DIV, a, b);
}

// One PE over P pixels: pe(...) per lane with the opcode a constant.  The
// opcode (uniform across the block) is matched by a chain of branches in
// order of how often the library apps use it, which measured faster on the
// H100 than a switch's indirect jump.
template <typename T>
__device__ __forceinline__ Vec<T> pe_vec(int op, const Vec<T>& a, const Vec<T>& b) {
  if (op == ADD) return pe_lanes<ADD>(a, b);
  if (op == MUL) return pe_lanes<MUL>(a, b);
  if (op == SUB) return pe_lanes<SUB>(a, b);
  if (op == BUF) return pe_lanes<BUF>(a, b);
  if (op == DIV) {
    Vec<T> r;
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i) r.v[i] = div_lane(a.v[i], b.v[i]);
    return r;
  }
  if (op == GT) return pe_lanes<GT>(a, b);
  if (op == MAX) return pe_lanes<MAX>(a, b);
  if (op == MIN) return pe_lanes<MIN>(a, b);
  if (op == ABS) return pe_lanes<ABS>(a, b);
  if (op == EQ) return pe_lanes<EQ>(a, b);
  return zero_vec<T>();  // NONE, MAC and unknown opcodes
}

struct Layout {
  // Byte offsets into dynamic shared memory, and the region buffers' shape.
  size_t buf1, vals_a, vals_b, consts, ints, total;
  int rows, cols;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Ints of one (stage, app) settings record: live PEs uint2[L * max_w]
// (each level's row: its live PEs in slot order), live taps int2[C]
// (offset, destination), live counts[L], live consts' destinations[C],
// live zeros' destinations[C], out_sel offsets[K], the three channel
// counts, the forwarded offset; rounded up to 4 ints so that every record
// starts 16-byte aligned.
__host__ __device__ inline int record_ints(int C, int L, int max_w, int K) {
  return (2 * L * max_w + L + 4 * C + K + 4 + 3) & ~3;
}

// buf0 | buf1 | vals_a[slots_a][threads] | vals_b[slots_b][threads] (16-byte
// vectors) | the live channels' consts[C] | the stage's settings record.
__host__ __device__ inline Layout smem_layout(int elem, int R, int slots_a, int slots_b,
                                              int threads, int C, int L, int max_w,
                                              int K) {
  const int p = 16 / elem;
  const int rp = (R + p - 1) / p * p;
  Layout l;
  l.rows = kTileRows + 2 * R;
  l.cols = kTileRows * p + 2 * rp + 2 * p;
  const size_t buf = align16(static_cast<size_t>(l.rows) * l.cols * elem);
  l.buf1 = buf;
  l.vals_a = 2 * buf;
  l.vals_b = l.vals_a + static_cast<size_t>(slots_a) * threads * 16;
  l.consts = l.vals_b + static_cast<size_t>(slots_b) * threads * 16;
  l.ints = l.consts + align16(static_cast<size_t>(C) * elem);
  l.total = l.ints + sizeof(int) * static_cast<size_t>(record_ints(C, L, max_w, K));
  return l;
}

// One warp per (stage, app): the settings record the main kernel stages
// before that stage.  Liveness walks the app's levels back from the
// outputs the stage needs (the last stage's K, else the forwarded
// channel): a PE is kept only if one of them depends on it, a channel only
// if a kept level-0 PE reads it.  A kept PE is packed as .x = opcode | a *
// threads << 4 | b * threads << 18 (its selects' offsets in the value
// columns), .y = its destination's offset.
template <typename T>
__global__ void __launch_bounds__(32)
vcgra_pipeline_settings(const int* __restrict__ ops, const int* __restrict__ sel,
                        const int* __restrict__ out_sel, const int* __restrict__ tap_sel,
                        const T* __restrict__ consts, const int* __restrict__ out_chs,
                        const int* __restrict__ widths, const int* __restrict__ radii,
                        int* __restrict__ records, T* __restrict__ rec_consts, int S, int N,
                        int L, int max_w, int K, int C, int R, int threads) {
  const int app = blockIdx.x, s = app / N, lane = threadIdx.x;
  const bool last = s == S - 1;
  const int wb = smem_layout(sizeof(T), R, 1, 1, threads, C, L, max_w, K).cols;
  int* rec = records + static_cast<int64_t>(app) * record_ints(C, L, max_w, K);
  uint2* r_pe = reinterpret_cast<uint2*>(rec);
  int2* r_tap = reinterpret_cast<int2*>(r_pe + L * max_w);
  int* r_nlive = reinterpret_cast<int*>(r_tap + C);
  int* r_cdst = r_nlive + L;
  int* r_zdst = r_cdst + C;
  int* r_out = r_zdst + C;
  int* r_counts = r_out + K;  // taps, consts, zeros
  int* r_fwd = r_counts + 3;
  const unsigned below = (1u << lane) - 1;
  const int* a_out = out_sel + static_cast<int64_t>(app) * K;

  uint64_t live = 0;
  for (int k = last ? 0 : out_chs[app]; k < (last ? K : out_chs[app] + 1); ++k)
    live |= 1ull << (a_out[k] & (kMaxVals - 1));
  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const int width = widths[lvl];
    const int* lops = ops + (static_cast<int64_t>(app) * L + lvl) * max_w;
    const int* lsel = sel + (static_cast<int64_t>(app) * L + lvl) * max_w * 2;
    uint64_t need = 0;
    int count = 0;
    for (int base = 0; base < width; base += 32) {
      const int slot = base + lane;
      const bool on = slot < width && ((live >> slot) & 1);
      const unsigned ballot = __ballot_sync(FULL_LANES, on);
      if (on) {
        const int code = lops[slot];
        const int op = code >= ADD && code <= ABS ? code : NONE;
        const int a = lsel[2 * slot] & (kMaxVals - 1), b = lsel[2 * slot + 1] & (kMaxVals - 1);
        r_pe[lvl * max_w + count + __popc(ballot & below)] = make_uint2(
            static_cast<uint32_t>(op) | (static_cast<uint32_t>(a * threads) << 4) |
                (static_cast<uint32_t>(b * threads) << 18),
            static_cast<uint32_t>(slot * threads));
        if (op != NONE) need |= (1ull << a) | (1ull << b);
      }
      count += __popc(ballot);
    }
    if (lane == 0) r_nlive[lvl] = count;
    live = __reduce_or_sync(FULL_LANES, static_cast<unsigned>(need)) |
           (static_cast<uint64_t>(__reduce_or_sync(FULL_LANES, static_cast<unsigned>(need >> 32)))
            << 32);
  }
  // The kept channels in three lists: taps (buffer offset dy * row + dx
  // from the pixel, destination), consts (destination, value), zeros.
  const int r = radii[s], side = 2 * r + 1;
  int n_tap = 0, n_const = 0, n_zero = 0;
  for (int base = 0; base < C; base += 32) {
    const int c = base + lane;
    const int t = c < C && ((live >> c) & 1) ? tap_sel[static_cast<int64_t>(app) * C + c] : -2;
    const int kind = t == -2 ? -1 : t == side * side ? kConst
                              : (t >= 0 && t < side * side) ? kTap : kZero;
    const unsigned taps = __ballot_sync(FULL_LANES, kind == kTap);
    const unsigned cons = __ballot_sync(FULL_LANES, kind == kConst);
    const unsigned zeros = __ballot_sync(FULL_LANES, kind == kZero);
    if (kind == kTap) {  // .y: destination | the read's misalignment in elements << 16
      constexpr int P = 16 / static_cast<int>(sizeof(T));
      const int dx = t % side - r;
      r_tap[n_tap + __popc(taps & below)] =
          make_int2((t / side - r) * wb + dx, c * threads | (((dx % P) + P) % P) << 16);
    }
    if (kind == kConst) {
      const int i = n_const + __popc(cons & below);
      r_cdst[i] = c * threads;
      rec_consts[static_cast<int64_t>(app) * C + i] = consts[static_cast<int64_t>(app) * C + c];
    }
    if (kind == kZero) r_zdst[n_zero + __popc(zeros & below)] = c * threads;
    n_tap += __popc(taps);
    n_const += __popc(cons);
    n_zero += __popc(zeros);
  }
  for (int k = lane; k < K; k += 32) r_out[k] = (a_out[k] & (kMaxVals - 1)) * threads;
  if (lane == 0) {
    r_counts[0] = n_tap;
    r_counts[1] = n_const;
    r_counts[2] = n_zero;
    *r_fwd = last ? 0 : (a_out[out_chs[app]] & (kMaxVals - 1)) * threads;
  }
}

// A thread's walk over a rows x cols grid of items, `step` items at a
// time, without a division per item.
struct Walk {
  int row, col, step_rows, step_cols, cols;
  __device__ Walk(int first, int step, int cols_)
      : row(first / cols_), col(first % cols_), step_rows(step / cols_),
        step_cols(step % cols_), cols(cols_) {}
  __device__ void next() {
    row += step_rows;
    col += step_cols;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(128)
vcgra_pipeline_batched_kernel(const T* __restrict__ frames, const int* __restrict__ records,
                              const T* __restrict__ rec_consts, const int* __restrict__ hw,
                              const int* __restrict__ radii,
                              T* __restrict__ out, int S, int N, int H, int W, int L,
                              int max_w, int K, int C, int R, int slots_a, int slots_b) {
  using V = Vec<T>;
  constexpr int P = V::N;
  constexpr int kTileCols = kTileRows * P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const Layout lay =
      smem_layout(sizeof(T), R, slots_a, slots_b, threads, C, L, max_w, K);
  const int n_rec = record_ints(C, L, max_w, K);
  T* const buf0 = reinterpret_cast<T*>(smem);
  const size_t buf_elems = lay.buf1 / sizeof(T);
  V* col_a = reinterpret_cast<V*>(smem + lay.vals_a) + tid;  // stride: threads
  V* col_b = reinterpret_cast<V*>(smem + lay.vals_b) + tid;
  T* s_cval = reinterpret_cast<T*>(smem + lay.consts);
  int* s_rec = reinterpret_cast<int*>(smem + lay.ints);
  const uint2* s_pe = reinterpret_cast<const uint2*>(s_rec);
  const int2* s_tap = reinterpret_cast<const int2*>(s_pe + L * max_w);
  const int* s_nlive = reinterpret_cast<const int*>(s_tap + C);
  const int* s_cdst = s_nlive + L;
  const int* s_zdst = s_cdst + C;
  const int* s_out = s_zdst + C;
  const int* s_counts = s_out + K;
  const int* s_fwd = s_counts + 3;

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const int64_t hw_px = static_cast<int64_t>(H) * W;
  const int h = hw[2 * n], w = hw[2 * n + 1];
  const int rp = (R + P - 1) / P * P;
  const int wb = lay.cols;
  // Buffer row j is global row ty0 - R + j; buffer column c is global
  // column gx_of_col0 + c.
  const int gx_of_col0 = tx0 - P - rp;

  {  // The frame window, zero outside [0,H) x [0,W).
    const T* frame = frames + static_cast<int64_t>(n) * hw_px;
    const int wcols = kTileCols + 2 * R, c0 = P + rp - R;
    // Eight loads in flight a thread, then their stores.
    for (Walk it(tid, threads, wcols); it.row < lay.rows;) {
      T v[8];
      int at[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int gy = ty0 - R + it.row, gx = tx0 - R + it.col;
        const bool inside = it.row < lay.rows && gy >= 0 && gy < H && gx >= 0 && gx < W;
        v[u] = inside ? frame[static_cast<int64_t>(gy) * W + gx] : zero_value<T>();
        at[u] = it.row < lay.rows ? it.row * wb + c0 + it.col : -1;
        it.next();
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (at[u] >= 0) buf0[at[u]] = v[u];
    }
  }

  int cur_buf = 0, reach_in = R;
  for (int s = 0; s < S; ++s) {
    __syncthreads();  // the previous stage is done with settings and buffers
    const int64_t app = static_cast<int64_t>(s) * N + n;
    for (int i = tid; i < n_rec; i += threads) s_rec[i] = records[app * n_rec + i];
    for (int i = tid; i < C; i += threads) s_cval[i] = rec_consts[app * C + i];
    __syncthreads();

    const int r = radii[s];
    const int reach = reach_in - r;
    const bool last = s == S - 1;
    const T* in = buf0 + cur_buf * buf_elems;
    T* nxt = buf0 + (1 - cur_buf) * buf_elems;
    const int fwd = *s_fwd, n_tap = s_counts[0], n_const = s_counts[1], n_zero = s_counts[2];
    // This stage's region in whole P-pixel groups of buffer columns.
    const int row0 = R - reach, n_rows = kTileRows + 2 * reach;
    const int g0 = (P + rp - reach) / P;
    const int n_groups = (P + rp + kTileCols + reach + P - 1) / P - g0;
    for (Walk it(tid, threads, n_groups); it.row < n_rows; it.next()) {
      const int j = row0 + it.row, c0 = (g0 + it.col) * P;
      const int base = j * wb + c0;
      // Channels: taps, then consts and zeros.  An aligned tap is one
      // 16-byte read; a misaligned one, of a 4-byte dtype, two aligned
      // reads and a shift of m elements, of a 2-byte dtype P scalar reads.
      // Two taps at a time, the next two's records loaded meanwhile.
      auto fetch = [&](int2 t) {
        const int m = t.y >> 16;
        V x;
        if (m == 0) {
          x = *reinterpret_cast<const V*>(in + base + t.x);
        } else if constexpr (P == 4) {
          const V* at = reinterpret_cast<const V*>(in + base + t.x - m);
          const V lo = at[0], hi = at[1];
          x = m == 1 ? V{{lo.v[1], lo.v[2], lo.v[3], hi.v[0]}}
            : m == 2 ? V{{lo.v[2], lo.v[3], hi.v[0], hi.v[1]}}
                     : V{{lo.v[3], hi.v[0], hi.v[1], hi.v[2]}};
        } else {
#pragma unroll
          for (int e = 0; e < P; ++e) x.v[e] = in[base + t.x + e];
        }
        return x;
      };
      if (n_tap > 0) {
        const int last_tap = n_tap - 1;
        int2 t0 = s_tap[0], t1 = s_tap[min(1, last_tap)];
        for (int c = 0; c < n_tap; c += 2) {
          const int2 u0 = s_tap[min(c + 2, last_tap)], u1 = s_tap[min(c + 3, last_tap)];
          const V x0 = fetch(t0), x1 = fetch(t1);
          col_a[t0.y & 0xffff] = x0;
          col_a[t1.y & 0xffff] = x1;  // the same tap again when n_tap is odd
          t0 = u0;
          t1 = u1;
        }
      }
      for (int c = 0; c < n_const; ++c) {
        V x;
#pragma unroll
        for (int e = 0; e < P; ++e) x.v[e] = s_cval[c];
        col_a[s_cdst[c]] = x;
      }
      for (int c = 0; c < n_zero; ++c) col_a[s_zdst[c]] = zero_vec<T>();
      V* src = col_a;
      V* dst = col_b;
      for (int lvl = 0; lvl < L; ++lvl) {
        // One PE at a time, the next one's operands and the one after
        // its settings loaded while this one computes (a level's PEs read
        // only the level before it).
        const uint2* pes = s_pe + lvl * max_w;
        const int n_live = s_nlive[lvl];
        if (n_live > 0) {  // a level may keep no PE (its readers are NONE)
          const int end = n_live - 1;
          uint2 cur = pes[0], nxt = pes[min(1, end)];
          V a = src[(cur.x >> 4) & 0x3fff], b = src[cur.x >> 18];
          for (int k = 0; k < n_live; ++k) {
            const uint2 nxt2 = pes[min(k + 2, end)];
            const V a_next = src[(nxt.x >> 4) & 0x3fff], b_next = src[nxt.x >> 18];
            dst[cur.y] = pe_vec(static_cast<int>(cur.x & 15), a, b);
            cur = nxt;
            nxt = nxt2;
            a = a_next;
            b = b_next;
          }
        }
        V* t = src;
        src = dst;
        dst = t;
      }
      const int gy = ty0 - R + j, gx0 = gx_of_col0 + c0;
      if (last) {
        if (gy < H) {
          const int64_t p = static_cast<int64_t>(gy) * W + gx0;
          for (int k = 0; k < K; ++k) {
            const V y = src[s_out[k]];
            T* o = out + (static_cast<int64_t>(n) * K + k) * hw_px + p;
            if (W % P == 0 && gx0 + P <= W) {
              *reinterpret_cast<V*>(o) = y;
            } else {
#pragma unroll
              for (int i = 0; i < P; ++i)
                if (gx0 + i < W) o[i] = y.v[i];
            }
          }
        }
      } else {
        V y = src[fwd];
        const bool row_in = gy >= 0 && gy < h;
#pragma unroll
        for (int i = 0; i < P; ++i)
          if (!(row_in && gx0 + i >= 0 && gx0 + i < w)) y.v[i] = zero_value<T>();
        *reinterpret_cast<V*>(nxt + base) = y;
      }
    }
    cur_buf = 1 - cur_buf;
    reach_in = reach;
  }
}

template <typename T>
int launch_pipeline(const void* frames, const int* ops, const int* sel, const int* out_sel,
                    const int* tap_sel, const void* consts, const int* out_chs, const int* hw,
                    const int* widths, const int* radii, int* records, void* rec_consts,
                    void* out, int S, int N, int H, int W, int L, int max_w, int K, int C,
                    int R, int threads, int slots_a, int slots_b, cudaStream_t stream) {
  const size_t smem =
      smem_layout(sizeof(T), R, slots_a, slots_b, threads, C, L, max_w, K).total;
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vcgra_pipeline_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  vcgra_pipeline_settings<T><<<S * N, 32, 0, stream>>>(
      ops, sel, out_sel, tap_sel, static_cast<const T*>(consts), out_chs, widths, radii,
      records, static_cast<T*>(rec_consts), S, N, L, max_w, K, C, R, threads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int tile_cols = kTileRows * Vec<T>::N;
  const dim3 grid((W + tile_cols - 1) / tile_cols, (H + kTileRows - 1) / kTileRows, N);
  vcgra_pipeline_batched_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(frames), records, static_cast<const T*>(rec_consts), hw, radii,
      static_cast<T*>(out), S, N, H, W, L, max_w, K, C, R, slots_a, slots_b);
  return static_cast<int>(cudaGetLastError());
}

bool valid_launch(int S, int R, int C, int max_w, int threads, int slots_a, int slots_b) {
  return S >= 1 && R >= 0 && R <= kMaxTotalRadius && C <= kMaxVals && max_w <= kMaxVals &&
         slots_a >= C && slots_a >= 1 && slots_a <= kMaxVals && slots_b >= 1 &&
         slots_b <= kMaxVals && (threads == 32 || threads == 64 || threads == 128);
}

}  // namespace

extern "C" int vcgra_max_vals() { return kMaxVals; }
extern "C" int vcgra_max_radius() { return kMaxTotalRadius; }

// Bytes of dynamic shared memory one block takes (elem: the dtype's bytes).
extern "C" int vcgra_pipeline_smem(int elem, int R, int slots_a, int slots_b, int threads,
                                   int C, int L, int max_w, int K) {
  return static_cast<int>(
      smem_layout(elem, R, slots_a, slots_b, threads, C, L, max_w, K).total);
}

// Ints of one (stage, app) settings record.
extern "C" int vcgra_pipeline_record_ints(int C, int L, int max_w, int K) {
  return record_ints(C, L, max_w, K);
}

// Registers a thread of the kernel for dtype code `dtype` takes, or -1.
extern "C" int vcgra_pipeline_regs(int dtype) {
  const void* fn = dtype == 0   ? reinterpret_cast<const void*>(vcgra_pipeline_batched_kernel<int32_t>)
                   : dtype == 1 ? reinterpret_cast<const void*>(vcgra_pipeline_batched_kernel<int16_t>)
                   : dtype == 2 ? reinterpret_cast<const void*>(vcgra_pipeline_batched_kernel<float>)
                   : dtype == 3
                       ? reinterpret_cast<const void*>(vcgra_pipeline_batched_kernel<__nv_bfloat16>)
                       : nullptr;
  cudaFuncAttributes attr;
  if (fn == nullptr || cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  return attr.numRegs;
}

// dtype codes: 0 int32, 1 int16, 2 float32, 3 bfloat16.  threads (32, 64
// or 128) per block; slots_a / slots_b: the two value banks' slots (bank
// A: the C channels and levels 1, 3, ...; bank B: levels 0, 2, ...).  A
// bad code, an empty chain, R > kMaxTotalRadius, a value vector wider than
// kMaxVals or a block over kMaxSmem returns cudaErrorInvalidValue without
// launching.  radii: int32 [S] on the device; the settings carry a leading
// stage axis [S, N, ...].  Scratch the caller allocates: records int32
// [S * N, vcgra_pipeline_record_ints(C, L, max_w, K)] and rec_consts [S *
// N, C] of the grid dtype, the settings records a first launch packs.
extern "C" int vcgra_pipeline_batched(int dtype, const void* frames, const int* ops,
                                      const int* sel, const int* out_sel, const int* tap_sel,
                                      const void* consts, const int* out_chs, const int* hw,
                                      const int* widths, const int* radii, void* records,
                                      void* rec_consts, void* out, int S,
                                      int N, int H, int W, int L, int max_w, int K, int C,
                                      int R, int threads, int slots_a, int slots_b,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_launch(S, R, C, max_w, threads, slots_a, slots_b))
    return static_cast<int>(cudaErrorInvalidValue);
#define VCGRA_PIPELINE(CODE, T)                                                             \
  case CODE:                                                                                \
    return launch_pipeline<T>(frames, ops, sel, out_sel, tap_sel, consts, out_chs, hw,      \
                              widths, radii, static_cast<int*>(records), rec_consts, out, \
                              S, N, H, W, L, max_w, K, C, R, threads,                     \
                              slots_a, slots_b, st);
  switch (dtype) {
    VCGRA_PIPELINE(0, int32_t)
    VCGRA_PIPELINE(1, int16_t)
    VCGRA_PIPELINE(2, float)
    VCGRA_PIPELINE(3, __nv_bfloat16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VCGRA_PIPELINE
}
