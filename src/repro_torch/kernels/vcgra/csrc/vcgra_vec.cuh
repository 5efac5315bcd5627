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
//     kMaxWindowRadius, and a chain's lone stage past it, take the same
//     kernel with taps read from device memory (kWindow false), still P
//     pixels a thread.
//   * Any value width.  The value banks stay in shared memory while a
//     block of 128 or 64 threads holds them (ops._block).  A wider
//     grid takes the kDeviceBanks instance of the same kernels: each
//     resident block's banks in a device-memory scratch the wrapper
//     allocates, the settings record and consts read where the pack
//     launch wrote them, and a grid-stride loop over the tiles, so the
//     scratch holds the resident blocks' banks, not the whole grid's.
//
// 64-bit index math for N*K*H*W and N*C*B.

#pragma once

#include "vcgra_pe.cuh"

namespace {

constexpr int kTileRows = 32;         // output tile rows; columns are 32 P
constexpr int kMaxWindowRadius = 16;  // largest radius (B3: a segment's sum of radii) a window holds
constexpr int kMaxSmem = 232448;      // shared memory a block may take
// Channel kinds, staged per stage.
constexpr int kTap = 0, kConst = 1, kZero = 2;
constexpr unsigned FULL_LANES = 0xffffffffu;

// How a live tap is encoded in a settings record (int2; .y = dest, the
// channel's offset in the value columns):
//   kWindowTaps   .x = dy * row + dx, its offset in the window buffer (row
//                 a multiple of P, so .x & (P - 1) is dx mod P, the read's
//                 misalignment);
//   kGlobalTaps   .x = dy << 16 | (dx & 0xffff) (both signed, 16 bits);
//   kChannelTaps  .x = c, the channel's row of a [C, B] input.
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

// Ints of one (stage, app) settings record: live PEs uint4[L * max_w]
// (each level's row: its live PEs in slot order), live taps int2[C]
// (encoded by TapMode), live counts[L], live consts' destinations[C],
// live zeros' destinations[C], out_sel offsets[K], the three channel
// counts, the forwarded offset; rounded up to 4 ints so that every record
// starts 16-byte aligned.
__host__ __device__ inline int record_ints(int C, int L, int max_w, int K) {
  return (4 * L * max_w + L + 4 * C + K + 4 + 3) & ~3;
}

// A settings record viewed as its lists.
struct Record {
  uint4* pe;    // [L][max_w]: opcode, a's offset, b's offset, dest's offset
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
  r.pe = reinterpret_cast<uint4*>(rec);
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
// x (32P + 2Rp + 2P) elements (B3 two, B1 one, the global-tap paths and
// B2 none; Rp = R rounded up to P) | vals_a[slots_a][threads] |
// vals_b[slots_b][threads] (16-byte vectors) | the live channels'
// consts[C] | the stage's settings record.  With device_banks only the
// window buffers: banks, consts and record stay in device memory.
__host__ __device__ inline Layout smem_layout(int elem, int R, int buffers, int slots_a,
                                              int slots_b, int threads, int C, int L,
                                              int max_w, int K, bool device_banks) {
  const int p = 16 / elem;
  const int rp = (R + p - 1) / p * p;
  Layout l;
  l.rows = kTileRows + 2 * R;
  l.cols = kTileRows * p + 2 * rp + 2 * p;
  const size_t buf =
      buffers > 0 ? align16(static_cast<size_t>(l.rows) * l.cols * elem) : 0;
  l.buf1 = buf;
  l.vals_a = buffers * buf;
  if (device_banks) {
    l.vals_b = l.consts = l.ints = l.total = l.vals_a;
    return l;
  }
  l.vals_b = l.vals_a + static_cast<size_t>(slots_a) * threads * 16;
  l.consts = l.vals_b + static_cast<size_t>(slots_b) * threads * 16;
  l.ints = l.consts + align16(static_cast<size_t>(C) * elem);
  l.total = l.ints + sizeof(int) * static_cast<size_t>(record_ints(C, L, max_w, K));
  return l;
}

// Bytes of the pack launch's dynamic shared memory: two liveness bitmaps
// of one bit per value slot, max(C, max_w) bits each.
__host__ __device__ inline int pack_smem(int C, int max_w) {
  return 2 * 4 * (((C > max_w ? C : max_w) + 31) / 32);
}

// One warp per (stage, app): the settings record the main kernel stages
// before that stage.  Liveness walks the app's levels back from the
// outputs the stage needs (the K outputs of a stage that writes them, else
// the forwarded channel: every stage of a chain but the last, and the
// last stage of a segment that forwards), in two bitmaps in shared memory
// as wide as the grid (pack_smem): a PE is kept only if one of them
// depends on it, a channel only if a kept level-0 PE reads it.  A kept PE
// is packed as (opcode, a * threads, b * threads, slot * threads): its
// selects' and its destination's offsets in the value columns.  Kept
// channels go in three lists: taps (encoded by tap_mode; `row` is the
// window buffer's row length), consts (destination, value into
// rec_consts) and zeros.  With kChannelTaps (pre-packed channels: no
// tap_sel, consts or radii) every kept channel is a tap.  Select indices
// wrap at the bitmap's width, which the assembler's settings never reach.
// On the pipe-shared grid gauss3 keeps 26 of 32 PEs, sobel_x 21,
// threshold 6 (B5 drops dead PEs the same way, at compile time).
template <typename T>
__global__ void __launch_bounds__(32)
vcgra_pack_settings(const int* __restrict__ ops, const int* __restrict__ sel,
                    const int* __restrict__ out_sel, const int* __restrict__ tap_sel,
                    const T* __restrict__ consts, const int* __restrict__ out_chs,
                    const int* __restrict__ widths, const int* __restrict__ radii,
                    int* __restrict__ records, T* __restrict__ rec_consts, int S, int N,
                    int L, int max_w, int K, int C, int tap_mode, int row, int threads,
                    bool forward) {
  extern __shared__ unsigned bitmaps[];
  const int app = blockIdx.x, s = app / N, lane = threadIdx.x;
  const bool outputs = s == S - 1 && !forward;
  const Record rec =
      record_at(records + static_cast<int64_t>(app) * record_ints(C, L, max_w, K), C, L,
                max_w, K);
  const unsigned below = (1u << lane) - 1;
  const int* a_out = out_sel + static_cast<int64_t>(app) * K;
  const unsigned nv = static_cast<unsigned>(C > max_w ? C : max_w);
  const int words = static_cast<int>((nv + 31) / 32);
  unsigned* live = bitmaps;
  unsigned* need = bitmaps + words;
  auto wrap = [nv](int v) { return static_cast<int>(static_cast<unsigned>(v) % nv); };

  for (int i = lane; i < 2 * words; i += 32) bitmaps[i] = 0;
  __syncwarp();
  const int first = outputs ? 0 : out_chs[app], stop = outputs ? K : first + 1;
  for (int k = first + lane; k < stop; k += 32) {
    const int v = wrap(a_out[k]);
    atomicOr(&live[v >> 5], 1u << (v & 31));
  }
  __syncwarp();
  for (int lvl = L - 1; lvl >= 0; --lvl) {
    const int width = widths[lvl];
    const int* lops = ops + (static_cast<int64_t>(app) * L + lvl) * max_w;
    const int* lsel = sel + (static_cast<int64_t>(app) * L + lvl) * max_w * 2;
    int count = 0;
    for (int base = 0; base < width; base += 32) {
      const int slot = base + lane;
      const bool on = slot < width && ((live[slot >> 5] >> (slot & 31)) & 1);
      const unsigned ballot = __ballot_sync(FULL_LANES, on);
      if (on) {
        const int code = lops[slot];
        const int op = code >= ADD && code <= ABS ? code : NONE;
        const int a = wrap(lsel[2 * slot]), b = wrap(lsel[2 * slot + 1]);
        rec.pe[lvl * max_w + count + __popc(ballot & below)] = make_uint4(
            static_cast<uint32_t>(op), static_cast<uint32_t>(a * threads),
            static_cast<uint32_t>(b * threads), static_cast<uint32_t>(slot * threads));
        if (op != NONE) {
          atomicOr(&need[a >> 5], 1u << (a & 31));
          atomicOr(&need[b >> 5], 1u << (b & 31));
        }
      }
      count += __popc(ballot);
    }
    if (lane == 0) rec.nlive[lvl] = count;
    __syncwarp();
    unsigned* t = live;  // this level's needs are the level below's live slots
    live = need;
    need = t;
    for (int i = lane; i < words; i += 32) need[i] = 0;
    __syncwarp();
  }
  const bool packed = tap_mode == kChannelTaps;
  const int r = packed ? 0 : radii[s], side = 2 * r + 1;
  int n_tap = 0, n_const = 0, n_zero = 0;
  for (int base = 0; base < C; base += 32) {
    const int c = base + lane;
    const bool on = c < C && ((live[c >> 5] >> (c & 31)) & 1);
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
        v.x = tap_mode == kGlobalTaps
                  ? static_cast<int>((static_cast<uint32_t>(dy) << 16) |
                                     (static_cast<uint32_t>(dx) & 0xffffu))
                  : dy * row + dx;
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
  for (int k = lane; k < K; k += 32) rec.out[k] = wrap(a_out[k]) * threads;
  if (lane == 0) {
    rec.counts[0] = n_tap;
    rec.counts[1] = n_const;
    rec.counts[2] = n_zero;
    *rec.fwd = outputs ? 0 : wrap(a_out[out_chs[app]]) * threads;
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
      col_a[t0.y] = x0;
      col_a[t1.y] = x1;  // the same tap again when n_tap is odd
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
    const uint4* pes = rec.pe + lvl * max_w;
    const int n_live = rec.nlive[lvl];
    if (n_live > 0) {  // a level may keep no PE (its readers are NONE)
      const int end = n_live - 1;
      uint4 cur = pes[0], nxt = pes[min(1, end)];
      V a = src[cur.y], b = src[cur.z];
      for (int k = 0; k < n_live; ++k) {
        const uint4 nxt2 = pes[min(k + 2, end)];
        const V a_next = src[nxt.y], b_next = src[nxt.z];
        dst[cur.w] = pe_vec(static_cast<int>(cur.x), a, b);
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

// One group's P values at o: one 16-byte store where the group is whole
// and aligned, else its first `valid` lanes.
template <typename T>
__device__ __forceinline__ void store_vec(T* o, const Vec<T>& y, bool whole, int64_t valid) {
  if (whole) {
    *reinterpret_cast<Vec<T>*>(o) = y;
  } else {
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i)
      if (i < valid) o[i] = y.v[i];
  }
}

// A group's K outputs, output k at o + k * stride.
template <typename T>
__device__ __forceinline__ void store_outputs(T* o, int64_t stride, const Vec<T>* src,
                                              const int* out, int K, bool whole,
                                              int64_t valid) {
  for (int k = 0; k < K; ++k) store_vec(o + k * stride, src[out[k]], whole, valid);
}

// One block per (app n, 32-row x 32P-column output tile).  With kWindow it
// loads the (32 + 2R) x (32P + 2R) window of the frame into shared memory
// once (taps outside [0,H) x [0,W) read 0); without it (a radius past
// kMaxWindowRadius, R = 0) each tap is read from the frame in device
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
// writes K outputs unmasked ([N, K, H*W]; the caller slices) or, with
// `forward` (a segment of a longer chain), its masked forward as the next
// segment's frame ([N, H, W], 0 outside each app's [0,h) x [0,w)).  The
// chain instance without a window runs one stage: a lone stage whose
// radius is past kMaxWindowRadius.
//
// Without kChain (B1): S = 1, one window buffer (or none), no hw, no
// forward and no mask.
//
// kDeviceBanks: the value banks in `vals` ([gridDim.x][slots_a + slots_b]
// [threads] vectors), the record and consts read from `records` and
// `rec_consts`, and the block walks tiles t = blockIdx.x, + gridDim.x, ...
// (columns fastest, then rows, then apps, as the 3-D grid orders them).
// Launch bounds of two 128-thread blocks an SM (B3's shared memory holds
// two at the chain shape): with one bound ptxas held B3 at 64 registers
// and spilled; with two it takes 93 and runs 1.4% faster there.
template <typename T, bool kChain, bool kWindow, bool kDeviceBanks>
__global__ void __launch_bounds__(128, 2)
vcgra_tile_kernel(const T* __restrict__ frames, const int* __restrict__ records,
                  const T* __restrict__ rec_consts, const int* __restrict__ hw,
                  const int* __restrict__ radii, T* __restrict__ out, Vec<T>* __restrict__ vals,
                  int S, int N, int H, int W, int L, int max_w, int K, int C, int R,
                  int slots_a, int slots_b, bool forward) {
  using V = Vec<T>;
  constexpr int P = V::N;
  constexpr int kTileCols = kTileRows * P;
  constexpr int kBuffers = kChain && kWindow ? 2 : kWindow ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const Layout lay = smem_layout(sizeof(T), R, kBuffers, slots_a, slots_b, threads, C, L,
                                 max_w, K, kDeviceBanks);
  const int n_rec = record_ints(C, L, max_w, K);
  T* const buf0 = reinterpret_cast<T*>(smem);
  const size_t buf_elems = lay.buf1 / sizeof(T);
  V* col_a;  // stride: threads
  V* col_b;
  if constexpr (kDeviceBanks) {
    col_a = vals + static_cast<int64_t>(blockIdx.x) * (slots_a + slots_b) * threads + tid;
    col_b = col_a + static_cast<int64_t>(slots_a) * threads;
  } else {
    col_a = reinterpret_cast<V*>(smem + lay.vals_a) + tid;
    col_b = reinterpret_cast<V*>(smem + lay.vals_b) + tid;
  }
  T* const s_cval = reinterpret_cast<T*>(smem + lay.consts);
  int* const s_rec = reinterpret_cast<int*>(smem + lay.ints);
  const int rp = (R + P - 1) / P * P;
  const int wb = lay.cols;
  const int64_t hw_px = static_cast<int64_t>(H) * W;
  const int tiles_x = (W + kTileCols - 1) / kTileCols, tiles_y = (H + kTileRows - 1) / kTileRows;
  const int64_t n_tiles = kDeviceBanks ? static_cast<int64_t>(tiles_x) * tiles_y * N : 1;

  for (int64_t tile = kDeviceBanks ? blockIdx.x : 0; tile < n_tiles;
       tile += kDeviceBanks ? gridDim.x : 1) {
    const int n = kDeviceBanks ? static_cast<int>(tile / (static_cast<int64_t>(tiles_x) * tiles_y))
                               : blockIdx.z;
    const int ty0 = (kDeviceBanks ? static_cast<int>(tile / tiles_x % tiles_y) : blockIdx.y) *
                    kTileRows;
    const int tx0 = (kDeviceBanks ? static_cast<int>(tile % tiles_x) : blockIdx.x) * kTileCols;
    const T* frame = frames + static_cast<int64_t>(n) * hw_px;
    int h = 0, w = 0;
    if constexpr (kChain) {
      h = hw[2 * n];
      w = hw[2 * n + 1];
    }
    // Buffer row j is global row ty0 - R + j; buffer column c is global
    // column gx_of_col0 + c.
    const int gx_of_col0 = tx0 - P - rp;
    if constexpr (kDeviceBanks) __syncthreads();  // the previous tile is done with the window

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
      const T* cval = s_cval;
      int* rec_ints = s_rec;
      if constexpr (kDeviceBanks) {
        cval = rec_consts + app * C;
        rec_ints = const_cast<int*>(records) + app * n_rec;
      } else {
        for (int i = tid; i < n_rec; i += threads) s_rec[i] = records[app * n_rec + i];
        for (int i = tid; i < C; i += threads) s_cval[i] = rec_consts[app * C + i];
      }
      __syncthreads();
      const Record rec = record_at(rec_ints, C, L, max_w, K);

      const int reach = kChain && kWindow ? reach_in - radii[s] : 0;
      const bool last = s == S - 1;
      const bool outputs = !kChain || (last && !forward);
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
            const int m = t.x & (P - 1);
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
            const int yy = gy + (t.x >> 16), xx = gx0 + static_cast<int16_t>(t.x & 0xffff);
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
            eval_group<T>(col_a, col_b, rec, cval, n_tap, n_const, n_zero, L, max_w, fetch);
        const bool whole = W % P == 0 && gx0 + P <= W;
        if (outputs) {
          if (gy < H)
            store_outputs<T>(out + static_cast<int64_t>(n) * K * hw_px +
                                 static_cast<int64_t>(gy) * W + gx0,
                             hw_px, src, rec.out, K, whole, W - gx0);
        } else {
          V y = src[fwd];
          const bool row_in = gy >= 0 && gy < h;
#pragma unroll
          for (int i = 0; i < P; ++i)
            if (!(row_in && gx0 + i >= 0 && gx0 + i < w)) y.v[i] = zero_value<T>();
          if (!last)
            *reinterpret_cast<V*>(nxt + base) = y;
          else if (gy < H)
            store_vec<T>(out + static_cast<int64_t>(n) * hw_px + static_cast<int64_t>(gy) * W +
                             gx0, y, whole, W - gx0);
        }
      }
      cur_buf = 1 - cur_buf;
      reach_in = reach;
    }
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

// The pack launch, granted shared memory past 48 KB for a grid wide
// enough to need it.
template <typename T>
cudaError_t launch_pack(int apps, const int* ops, const int* sel, const int* out_sel,
                        const int* tap_sel, const void* consts, const int* out_chs,
                        const int* widths, const int* radii, int* records, void* rec_consts,
                        int S, int N, int L, int max_w, int K, int C, int tap_mode, int row,
                        int threads, bool forward, cudaStream_t stream) {
  const int bytes = pack_smem(C, max_w);
  cudaError_t err = allow_smem(vcgra_pack_settings<T>, bytes);
  if (err != cudaSuccess) return err;
  vcgra_pack_settings<T><<<apps, 32, bytes, stream>>>(
      ops, sel, out_sel, tap_sel, static_cast<const T*>(consts), out_chs, widths, radii,
      records, static_cast<T*>(rec_consts), S, N, L, max_w, K, C, tap_mode, row, threads,
      forward);
  return cudaGetLastError();
}

}  // namespace
