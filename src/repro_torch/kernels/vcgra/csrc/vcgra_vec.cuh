// The vectorised VCGRA pipeline, written once for four Hopper kernels:
// B1 (vcgra_fused_batched), B2 (vcgra_batched) and B4 (vcgra_conventional,
// B2's kernel over one app) in vcgra.cu, B3 (vcgra_pipeline_batched) in
// vcgra_pipeline.cu.
//
//   * P pixels a thread.  A thread carries P = 16 / sizeof(T) neighbouring
//     pixels (4 for int32 and float32, 8 for int16 and bf16) through every
//     PE: one settings read, one opcode dispatch and two 16-byte value
//     reads serve P pixels.  Value columns are 16-byte vectors,
//     vals[slot][thread], read and written without bank conflicts; they
//     ping-pong between two banks: bank A holds the C input channels and
//     the outputs of levels 1, 3, ...; bank B those of levels 0, 2, ...
//     (slots_a = max(C, widths of odd levels), slots_b = max of the even
//     ones; ops.value_slots).
//   * pe_vec: one call site for every PE.  It applies the scalar pe(...) of
//     vcgra_pe.cuh lane by lane with the opcode a constant, so the vector
//     PE is bitwise the scalar one; integer DIV by a positive power of two
//     is the arithmetic shift it equals.
//   * vcgra_pack_settings: a first launch, one warp per (stage, app),
//     decodes the dense settings bank into a record of the live PEs and
//     live channels only (its note).  A dead PE's value never reaches an
//     output, so skipping it changes no output bit.
//   * eval_group: one group of P pixels -- its live channels fetched by
//     the caller's fetch, then the live PEs with the next PE's operands
//     and the following one's settings loaded while one computes.
//   * vcgra_tile_kernel: one block per (app, 32-row x 32P-column output
//     tile), its frame window loaded into shared memory once; threads walk
//     the tile's (row, group) pairs by adding a precomputed step (Walk),
//     so no division or modulo runs per pixel.  B3 is its chain instance
//     (kChain), B1 its one-stage instance; B1's radii past
//     kMaxWindowRadius take the same kernel with taps read from device
//     memory (kWindow false), still P pixels a thread.
//
// 64-bit index math for N*K*H*W and N*C*B.

#pragma once

#include "vcgra_pe.cuh"

namespace {

constexpr int kTileRows = 32;         // output tile rows; columns are 32 P
constexpr int kVecMaxVals = 64;       // widest value vector: max(C, PEs a level)
constexpr int kMaxWindowRadius = 16;  // largest radius (B3: sum of stage radii) a window holds
constexpr int kMaxSmem = 232448;      // shared memory a block may take
// Channel kinds, staged per stage.
constexpr int kTap = 0, kConst = 1, kZero = 2;
constexpr unsigned FULL_LANES = 0xffffffffu;

// How a live tap is encoded in a settings record (int2; dest = the
// channel's offset in the value columns):
//   kWindowTaps   .x = dy * row + dx, its offset in the window buffer;
//                 .y = dest | (dx mod P) << 16, the read's misalignment;
//   kGlobalTaps   .x = dy; .y = dest | dx << 16 (dx signed, 16 bits);
//   kChannelTaps  .x = c, the channel's row of a [C, B] input; .y = dest.
enum TapMode : int { kWindowTaps = 0, kGlobalTaps = 1, kChannelTaps = 2 };

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
// (encoded by TapMode), live counts[L], live consts' destinations[C],
// live zeros' destinations[C], out_sel offsets[K], the three channel
// counts, the forwarded offset; rounded up to 4 ints so that every record
// starts 16-byte aligned.
__host__ __device__ inline int record_ints(int C, int L, int max_w, int K) {
  return (2 * L * max_w + L + 4 * C + K + 4 + 3) & ~3;
}

// A settings record viewed as its lists.
struct Record {
  uint2* pe;    // [L][max_w]: .x = opcode | a offset << 4 | b offset << 18, .y = dest
  int2* tap;    // [C]
  int* nlive;   // [L]
  int* cdst;    // [C]
  int* zdst;    // [C]
  int* out;     // [K]
  int* counts;  // taps, consts, zeros
  int* fwd;     // the forwarded slot's offset (B3)
};

__device__ inline Record record_at(int* rec, int C, int L, int max_w, int K) {
  Record r;
  r.pe = reinterpret_cast<uint2*>(rec);
  r.tap = reinterpret_cast<int2*>(r.pe + L * max_w);
  r.nlive = reinterpret_cast<int*>(r.tap + C);
  r.cdst = r.nlive + L;
  r.zdst = r.cdst + C;
  r.out = r.zdst + C;
  r.counts = r.out + K;
  r.fwd = r.counts + 3;
  return r;
}

// Dynamic shared memory of a block: `buffers` window buffers of (32 + 2R)
// x (32P + 2Rp + 2P) elements (B3 two, B1 one, B1's global-tap path and
// B2 none; Rp = R rounded up to P) | vals_a[slots_a][threads] |
// vals_b[slots_b][threads] (16-byte vectors) | the live channels'
// consts[C] | the stage's settings record.
__host__ __device__ inline Layout smem_layout(int elem, int R, int buffers, int slots_a,
                                              int slots_b, int threads, int C, int L,
                                              int max_w, int K) {
  const int p = 16 / elem;
  const int rp = (R + p - 1) / p * p;
  Layout l;
  l.rows = kTileRows + 2 * R;
  l.cols = kTileRows * p + 2 * rp + 2 * p;
  const size_t buf =
      buffers > 0 ? align16(static_cast<size_t>(l.rows) * l.cols * elem) : 0;
  l.buf1 = buf;
  l.vals_a = buffers * buf;
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
// columns), .y = its destination's offset.  Kept channels go in three
// lists: taps (encoded by tap_mode; `row` is the window buffer's row
// length), consts (destination, value into rec_consts) and zeros.  With
// kChannelTaps (pre-packed channels: no tap_sel, consts or radii) every
// kept channel is a tap.  On the pipe-shared grid gauss3 keeps 26 of 32
// PEs, sobel_x 21, threshold 6 (B5 drops dead PEs the same way, at
// compile time).
template <typename T>
__global__ void __launch_bounds__(32)
vcgra_pack_settings(const int* __restrict__ ops, const int* __restrict__ sel,
                    const int* __restrict__ out_sel, const int* __restrict__ tap_sel,
                    const T* __restrict__ consts, const int* __restrict__ out_chs,
                    const int* __restrict__ widths, const int* __restrict__ radii,
                    int* __restrict__ records, T* __restrict__ rec_consts, int S, int N,
                    int L, int max_w, int K, int C, int tap_mode, int row, int threads) {
  constexpr int P = Vec<T>::N;
  const int app = blockIdx.x, s = app / N, lane = threadIdx.x;
  const bool last = s == S - 1;
  const Record rec =
      record_at(records + static_cast<int64_t>(app) * record_ints(C, L, max_w, K), C, L,
                max_w, K);
  const unsigned below = (1u << lane) - 1;
  const int* a_out = out_sel + static_cast<int64_t>(app) * K;

  uint64_t live = 0;
  for (int k = last ? 0 : out_chs[app]; k < (last ? K : out_chs[app] + 1); ++k)
    live |= 1ull << (a_out[k] & (kVecMaxVals - 1));
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
        const int a = lsel[2 * slot] & (kVecMaxVals - 1);
        const int b = lsel[2 * slot + 1] & (kVecMaxVals - 1);
        rec.pe[lvl * max_w + count + __popc(ballot & below)] = make_uint2(
            static_cast<uint32_t>(op) | (static_cast<uint32_t>(a * threads) << 4) |
                (static_cast<uint32_t>(b * threads) << 18),
            static_cast<uint32_t>(slot * threads));
        if (op != NONE) need |= (1ull << a) | (1ull << b);
      }
      count += __popc(ballot);
    }
    if (lane == 0) rec.nlive[lvl] = count;
    live = __reduce_or_sync(FULL_LANES, static_cast<unsigned>(need)) |
           (static_cast<uint64_t>(__reduce_or_sync(FULL_LANES, static_cast<unsigned>(need >> 32)))
            << 32);
  }
  const bool packed = tap_mode == kChannelTaps;
  const int r = packed ? 0 : radii[s], side = 2 * r + 1;
  int n_tap = 0, n_const = 0, n_zero = 0;
  for (int base = 0; base < C; base += 32) {
    const int c = base + lane;
    const bool on = c < C && ((live >> c) & 1);
    const int t = on && !packed ? tap_sel[static_cast<int64_t>(app) * C + c] : 0;
    const int kind = !on ? -1 : packed || (t >= 0 && t < side * side) ? kTap
                              : t == side * side ? kConst : kZero;
    const unsigned taps = __ballot_sync(FULL_LANES, kind == kTap);
    const unsigned cons = __ballot_sync(FULL_LANES, kind == kConst);
    const unsigned zeros = __ballot_sync(FULL_LANES, kind == kZero);
    if (kind == kTap) {
      const int dest = c * threads;
      int2 v = make_int2(c, dest);
      if (!packed) {
        const int dy = t / side - r, dx = t % side - r;
        v = tap_mode == kGlobalTaps
                ? make_int2(dy, dest | static_cast<int>(static_cast<uint32_t>(dx) << 16))
                : make_int2(dy * row + dx, dest | (((dx % P) + P) % P) << 16);
      }
      rec.tap[n_tap + __popc(taps & below)] = v;
    }
    if (kind == kConst) {
      const int i = n_const + __popc(cons & below);
      rec.cdst[i] = c * threads;
      rec_consts[static_cast<int64_t>(app) * C + i] = consts[static_cast<int64_t>(app) * C + c];
    }
    if (kind == kZero) rec.zdst[n_zero + __popc(zeros & below)] = c * threads;
    n_tap += __popc(taps);
    n_const += __popc(cons);
    n_zero += __popc(zeros);
  }
  for (int k = lane; k < K; k += 32) rec.out[k] = (a_out[k] & (kVecMaxVals - 1)) * threads;
  if (lane == 0) {
    rec.counts[0] = n_tap;
    rec.counts[1] = n_const;
    rec.counts[2] = n_zero;
    *rec.fwd = last ? 0 : (a_out[out_chs[app]] & (kVecMaxVals - 1)) * threads;
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

// One group of P pixels through the pipeline; returns the value bank that
// holds the last level.  Channels first: taps by `fetch(int2 record)`, two
// at a time with the next two's records loaded meanwhile, then consts
// (s_cval) and zeros.  Then every level's live PEs, one at a time, the
// next one's operands and the one after its settings loaded while this
// one computes (a level's PEs read only the level before it).
template <typename T, typename Fetch>
__device__ __forceinline__ Vec<T>* eval_group(Vec<T>* col_a, Vec<T>* col_b, const Record& rec,
                                              const T* s_cval, int n_tap, int n_const,
                                              int n_zero, int L, int max_w, Fetch fetch) {
  using V = Vec<T>;
  constexpr int P = V::N;
  if (n_tap > 0) {
    const int last_tap = n_tap - 1;
    int2 t0 = rec.tap[0], t1 = rec.tap[min(1, last_tap)];
    for (int c = 0; c < n_tap; c += 2) {
      const int2 u0 = rec.tap[min(c + 2, last_tap)], u1 = rec.tap[min(c + 3, last_tap)];
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
    col_a[rec.cdst[c]] = x;
  }
  for (int c = 0; c < n_zero; ++c) col_a[rec.zdst[c]] = zero_vec<T>();
  V* src = col_a;
  V* dst = col_b;
  for (int lvl = 0; lvl < L; ++lvl) {
    const uint2* pes = rec.pe + lvl * max_w;
    const int n_live = rec.nlive[lvl];
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
  return src;
}

// A group's K outputs, output k at o + k * stride: one 16-byte store each
// where the group is whole and aligned, else its first `valid` lanes.
template <typename T>
__device__ __forceinline__ void store_outputs(T* o, int64_t stride, const Vec<T>* src,
                                              const int* out, int K, bool whole,
                                              int64_t valid) {
  for (int k = 0; k < K; ++k) {
    const Vec<T> y = src[out[k]];
    T* ok = o + k * stride;
    if (whole) {
      *reinterpret_cast<Vec<T>*>(ok) = y;
    } else {
#pragma unroll
      for (int i = 0; i < Vec<T>::N; ++i)
        if (i < valid) ok[i] = y.v[i];
    }
  }
}

// One block per (app n, 32-row x 32P-column output tile).  With kWindow it
// loads the (32 + 2R) x (32P + 2R) window of the frame into shared memory
// once (taps outside [0,H) x [0,W) read 0); without it (B1 at a radius
// past kMaxWindowRadius, R = 0) each tap is read from the frame in device
// memory, 0 outside it.
//
// kChain (B3), the trapezoid: R = sum of the stage radii; stage i computes
// the tile grown by reach_i = sum of the radii after i, in whole P-pixel
// groups, from the previous stage's region, into the second (ping-pong)
// window buffer.  Every buffer shares the window's coordinates (buffer
// column c is global column tx0 - P - Rp + c, Rp = R rounded up to P), so
// groups are 16-byte aligned in every stage; the columns a group computes
// beyond its region are never read by a pixel that is kept.  After every
// non-final stage a forwarded value whose global position lies outside
// the app's [0,h) x [0,w) (from hw) is set to 0, halo pixels outside the
// canvas included (h <= H, w <= W), which makes the chain bitwise equal to
// the staged oracle.  Forwarding follows the oracle
// (interpreter.forward_stage_output): stage i forwards its OUTPUT channel
// out_ch, i.e. the last level's slot out_sel[out_ch].  The last stage
// writes K outputs unmasked; the caller slices.
//
// Without kChain (B1): S = 1, one window buffer (or none), no hw, no
// forward and no mask.
template <typename T, bool kChain, bool kWindow>
__global__ void __launch_bounds__(128)
vcgra_tile_kernel(const T* __restrict__ frames, const int* __restrict__ records,
                  const T* __restrict__ rec_consts, const int* __restrict__ hw,
                  const int* __restrict__ radii, T* __restrict__ out, int S, int N, int H,
                  int W, int L, int max_w, int K, int C, int R, int slots_a, int slots_b) {
  static_assert(kWindow || !kChain, "a chain forwards through its window buffers");
  using V = Vec<T>;
  constexpr int P = V::N;
  constexpr int kTileCols = kTileRows * P;
  constexpr int kBuffers = kChain ? 2 : kWindow ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const Layout lay =
      smem_layout(sizeof(T), R, kBuffers, slots_a, slots_b, threads, C, L, max_w, K);
  const int n_rec = record_ints(C, L, max_w, K);
  T* const buf0 = reinterpret_cast<T*>(smem);
  const size_t buf_elems = lay.buf1 / sizeof(T);
  V* col_a = reinterpret_cast<V*>(smem + lay.vals_a) + tid;  // stride: threads
  V* col_b = reinterpret_cast<V*>(smem + lay.vals_b) + tid;
  T* s_cval = reinterpret_cast<T*>(smem + lay.consts);
  int* s_rec = reinterpret_cast<int*>(smem + lay.ints);
  const Record rec = record_at(s_rec, C, L, max_w, K);

  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const int64_t hw_px = static_cast<int64_t>(H) * W;
  const T* frame = frames + static_cast<int64_t>(n) * hw_px;
  int h = 0, w = 0;
  if constexpr (kChain) {
    h = hw[2 * n];
    w = hw[2 * n + 1];
  }
  const int rp = (R + P - 1) / P * P;
  const int wb = lay.cols;
  // Buffer row j is global row ty0 - R + j; buffer column c is global
  // column gx_of_col0 + c.
  const int gx_of_col0 = tx0 - P - rp;

  if constexpr (kWindow) {  // The frame window, zero outside [0,H) x [0,W).
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

    const int reach = kChain ? reach_in - radii[s] : 0;
    const bool last = !kChain || s == S - 1;
    const T* in = buf0 + cur_buf * buf_elems;
    T* nxt = buf0 + (1 - cur_buf) * buf_elems;
    const int fwd = *rec.fwd, n_tap = rec.counts[0], n_const = rec.counts[1];
    const int n_zero = rec.counts[2];
    // This stage's region in whole P-pixel groups of buffer columns.
    const int row0 = R - reach, n_rows = kTileRows + 2 * reach;
    const int g0 = (P + rp - reach) / P;
    const int n_groups = (P + rp + kTileCols + reach + P - 1) / P - g0;
    for (Walk it(tid, threads, n_groups); it.row < n_rows; it.next()) {
      const int j = row0 + it.row, c0 = (g0 + it.col) * P;
      const int base = j * wb + c0;
      const int gy = ty0 - R + j, gx0 = gx_of_col0 + c0;
      // A tap from the window: aligned, one 16-byte read; misaligned, of a
      // 4-byte dtype, two aligned reads and a shift of m elements, of a
      // 2-byte dtype P scalar reads.  From device memory: P scalar reads.
      auto fetch = [&](int2 t) {
        V x;
        if constexpr (kWindow) {
          const int m = t.y >> 16;
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
        } else {
          x = zero_vec<T>();
          const int yy = gy + t.x, xx = gx0 + (t.y >> 16);
          if (yy >= 0 && yy < H) {
            const T* frow = frame + static_cast<int64_t>(yy) * W;
#pragma unroll
            for (int e = 0; e < P; ++e)
              if (xx + e >= 0 && xx + e < W) x.v[e] = frow[xx + e];
          }
        }
        return x;
      };
      const V* src =
          eval_group<T>(col_a, col_b, rec, s_cval, n_tap, n_const, n_zero, L, max_w, fetch);
      if (last) {
        if (gy < H)
          store_outputs<T>(out + static_cast<int64_t>(n) * K * hw_px +
                               static_cast<int64_t>(gy) * W + gx0,
                           hw_px, src, rec.out, K, W % P == 0 && gx0 + P <= W, W - gx0);
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

// Shared memory above the default 48 KB is granted per kernel; returns the
// attribute call's error (cudaSuccess below 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Registers a thread of `kernel` takes, or -1.
template <typename Kernel>
int kernel_regs(Kernel kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return attr.numRegs;
}

}  // namespace
