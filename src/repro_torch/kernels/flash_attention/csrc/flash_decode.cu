// GQA flash decode attention for Hopper (sm_90a): one query token per
// sequence attends over the first lengths[b] rows of its k/v cache.
//
// Replaces the reference's Pallas TPU kernel `flash_decode`
// (src/repro/kernels/flash_attention/flash_kernel.py, `_decode_body`).
// The TPU kernel walks the cache's S axis in order on one core, carrying
// the online-softmax state (m, l, acc) in VMEM scratch from chunk to
// chunk.  On the H100 a block per (b, g) would fill only B * G of the 132
// SMs (8 for gemma-2b in the serving engine), so this is flash-decoding
// instead: a block per (split of S, kv group g, sequence b) writes one
// partial (m, l, acc) per head to float32 scratch that the wrapper
// allocates, and flash_decode_combine, one block per (head, g, b), merges
// the splits' partials (their weights exp(m_s - max) computed once, in
// shared memory) and writes acc / max(l, 1e-30) in q's dtype, so a
// sequence with no valid row gives exactly 0, as the Pallas kernel's
// denominator floor does.  A split that lies wholly past lengths[b]
// writes an empty partial (m = -1e30, l = 0) without reading k or v.
//
// The sequence-split entry: on a mesh that shards the cache's S over
// 'model', each rank runs this kernel on its own block of rows, masked by
// the wrapper to clamp(lengths - r0, 0, S_local) valid rows, and the
// combine also writes each head's float32 log-sum-exp of its scaled scores
// (-inf for no valid row) beside a float32 output; the ranks merge their
// blocks' outputs weighted by exp(lse - max lse) (ops.decode_attention_split).
// There v may be a column block of the rank's cache: Dv of its D columns
// (Dv divides D), v's pointer at the block's first column and its rows
// strided as k's.  The scores run over k's whole D; the weighted sum, the
// partials and the output over the Dv columns (the CUDA-core body only).
//
// Bound: the bytes of k and v up to lengths[b] (each read once); at the
// `decode_32k` shape of one gemma-2b layer (B 128, S 32768, G 1, D 256,
// bf16) that is 4.29 GB, 1.28 ms at 3.35 TB/s.  Two bodies compute a
// split; the wrapper picks one by the cache's dtype, Hg and D
// (ops.tensor_core_route), and a launch failure of either raises.
//
//   flash_decode_tc       a bf16 cache, D in {16, 32, 64, 128, 256}, Hg <=
//                         16: tensor cores fed by an asynchronous ring.
//     * The ring: TC_STAGES = 3 stages of TC_ROWS = 64 k rows and 64 v
//       rows (x D bf16) in dynamic shared memory, filled by cp.async (16
//       bytes a thread, all 128 threads), two tiles in flight while the
//       warps work on the third: 128 KB in flight per SM at D = 256, where
//       covering HBM's latency takes ~30 KB.  Rows past lengths[b] are
//       zero-filled (src-size 0), never read; nothing past S is read.
//       16-byte chunks are XOR-swizzled by row so ldmatrix is
//       conflict-free.
//     * Each warp owns 16 rows of every tile and keeps its own online
//       softmax.  Scores on tensor cores with the heads on the N side:
//       S^T[16 rows x 8 heads] = K[16 x D] . q^T[D x 8] by mma.sync
//       m16n8k16 (Hg padded to 8 or 16: one or two N tiles), K read by
//       ldmatrix, q's fragments staged once per block in shared memory.
//       A float32 q is split into three bf16 parts (hi, mid, lo), whose
//       products with bf16 k are exact in the float32 accumulator.
//     * Softmax per head column in float32 (expf, rows past the length
//       masked), the tile's max reduced across the warp by 3 shuffles.
//     * Output on tensor cores: O^T[D x 8] += V^T[D x 16] . P[16 x 8], V
//       read by ldmatrix.trans, P (float32) split into three bf16 parts
//       whose products with bf16 v are exact; the score fragment becomes
//       P's B fragment by movmatrix (an 8x8 transpose in registers).  So
//       the result differs from the CUDA-core body's only in summation
//       order.
//     * The four warps' states merge in shared memory (the ring reused)
//       into the block's partial.
//     * Shared memory (tc_smem_bytes): 768 D bytes of ring plus 16 D x
//       parts(q) x ceil(Hg / 8) of q fragments: 221,184 bytes at the
//       largest (D 256, float32 q, Hg 16), under the 232,448 a block may
//       take; gemma-2b (bf16 q, Hg 8, D 256) takes 200,704, one block of
//       4 warps an SM, which the ring, not the warp count, keeps busy.
//   flash_decode_partial  a float32 cache, or a D the tensor-core body does
//                         not take: the CUDA-core body.  Each of its warps
//                         takes two rows of the split at a time (every
//                         WARPS-th row); a lane holds D / 32 contiguous
//                         elements of the group's Hg query rows and of
//                         their running numerators in registers, loads its
//                         slice of the next two k and v rows while it
//                         works on the current ones, reduces each q.k
//                         score across the warp with shuffles and updates
//                         the online softmax without a branch.  The warps'
//                         (m, l, acc) merge in shared memory.
//
// Arithmetic follows the Pallas body: scores (q . k) * D^-0.5, softmax
// weights and sums in float32 (expf, IEEE division, no fast math), the
// output cast once at the end.  Only the summation order differs.
//
// Plain C interface, built by kernels/build.py with nvcc and bound with
// ctypes.  Every launch is checked with cudaGetLastError and the error is
// returned to the wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int COMBINE_THREADS = 256;
// HG * 32 * VEC <= GROUP_FLOATS and HG <= MAX_HEADS, HG the query heads
// of a group rounded up to a power of two: a lane keeps no more than 64 query
// and 64 accumulator floats.  Every zoo model qualifies (gemma-2b: Hg 8,
// D 256; glm4-9b: Hg 16, D 128).
constexpr int GROUP_FLOATS = 2048;
constexpr int MAX_HEADS = 16;
// The combine keeps one float per split in (default) shared memory.
constexpr int MAX_SPLITS = 8192;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A lane's VEC contiguous elements of one row, loaded as one vector.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename QT, typename KT, int VEC, int HG>
__global__ void __launch_bounds__(THREADS) flash_decode_partial(
    const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const int* __restrict__ lengths, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int S, int G, int Hg, int D, int Dv, int split_len,
    float scale) {
  static_assert(HG * 32 * VEC <= GROUP_FLOATS, "a lane's q and acc exceed the budget");
  constexpr int DMAX = 32 * VEC;
  __shared__ float sm_m[WARPS][HG];
  __shared__ float sm_l[WARPS][HG];
  __shared__ float sm_acc[WARPS][HG * DMAX];

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long part = ((long long)b * G + g) * gridDim.x + split;
  const int len = min(max(lengths[b], 0), S);
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  if (start >= end) {
    if (threadIdx.x < Hg) {
      part_m[part * Hg + threadIdx.x] = NEG_INF;
      part_l[part * Hg + threadIdx.x] = 0.f;
    }
    return;
  }

  const int d0 = lane * VEC;
  const bool active = d0 < D;  // only lanes past D when D < 32
  // v's columns d0 .. d0 + VEC - 1 of the Dv: all of them, some (Dv < VEC,
  // one lane, element by element) or none
  const bool vactive = d0 < Dv;
  const bool vpacked = d0 + VEC <= Dv;
  const QT* qg = q + ((long long)b * G + g) * Hg * D;
  // Heads Hg..HG-1 (HG is Hg rounded up to a power of two) hold q = 0:
  // their scores and sums are computed and never written.
  float qr[HG][VEC], acc[HG][VEC], m[HG], l[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qr[h][i] = (h < Hg && active) ? to_float(qg[h * D + d0 + i]) : 0.f;
      acc[h][i] = 0.f;
    }
  }

  // A warp takes its rows in pairs (t, t + WARPS), the next pair's loads in
  // flight while it works on this one.  No branch inside a pair, so the
  // scores, shuffles and exponentials of every head and both rows overlap.
  using P = Pack<KT, VEC>;
  const long long row_stride = (long long)G * D;
  const KT* kb = k + ((long long)b * S * G + g) * D + d0;
  const KT* vb = v + ((long long)b * S * G + g) * D + (vactive ? d0 : 0);
  auto fetch = [&](int row, P& kr, P& vr) {
    if (row < end && active) {
      kr = *reinterpret_cast<const P*>(kb + row * row_stride);
      if (vpacked) {
        vr = *reinterpret_cast<const P*>(vb + row * row_stride);
      } else if (vactive) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          vr.v[i] = d0 + i < Dv ? vb[row * row_stride + i] : from_float<KT>(0.f);
      }
    }
  };
  P k1{}, v1{}, k2{}, v2{};
  int t = start + warp;
  fetch(t, k1, v1);
  fetch(t + WARPS, k2, v2);
  for (; t < end; t += 2 * WARPS) {
    const bool second = t + WARPS < end;  // uniform across the warp
    float kf1[VEC], vf1[VEC], kf2[VEC], vf2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      kf1[i] = active ? to_float(k1.v[i]) : 0.f;
      vf1[i] = vactive ? to_float(v1.v[i]) : 0.f;
      kf2[i] = (active && second) ? to_float(k2.v[i]) : 0.f;
      vf2[i] = (vactive && second) ? to_float(v2.v[i]) : 0.f;
    }
    fetch(t + 2 * WARPS, k1, v1);
    fetch(t + 3 * WARPS, k2, v2);
    float s1[HG], s2[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        x = fmaf(qr[h][i], kf1[i], x);
        y = fmaf(qr[h][i], kf2[i], y);
      }
      s1[h] = x;
      s2[h] = y;
    }
    // An xor butterfly leaves the bitwise-same sum in every lane.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        s1[h] += __shfl_xor_sync(FULL_MASK, s1[h], o);
        s2[h] += __shfl_xor_sync(FULL_MASK, s2[h], o);
      }
    }
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float a = s1[h] * scale;
      const float c = second ? s2[h] * scale : NEG_INF;
      const float mx = fmaxf(m[h], fmaxf(a, c));
      const float alpha = expf(m[h] - mx);
      const float p1 = expf(a - mx), p2 = expf(c - mx);
      l[h] = l[h] * alpha + p1 + p2;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[h][i] = fmaf(p2, vf2[i], fmaf(p1, vf1[i], acc[h][i] * alpha));
      m[h] = mx;
    }
  }

  // Merge the warps' states into the block's partial.
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    if (h < Hg) {
      if (lane == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
      if (vactive) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          if (d0 + i < Dv) sm_acc[warp][h * Dv + d0 + i] = acc[h][i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Hg * Dv; idx += THREADS) {
    const int h = idx / Dv;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][h]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sm_acc[w][idx] * expf(sm_m[w][h] - mx);
    part_acc[part * Hg * Dv + idx] = a;
  }
  if (threadIdx.x < Hg) {
    const int h = threadIdx.x;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][h]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += sm_l[w][h] * expf(sm_m[w][h] - mx);
    part_m[part * Hg + h] = mx;
    part_l[part * Hg + h] = sum;
  }
}

// --- the tensor-core body (a bf16 cache) ----------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_ROWS = 16 * TC_WARPS;  // rows of a ring stage, 16 a warp
constexpr int TC_STAGES = 3;
constexpr int P_PARTS = 3;  // bf16 parts of a softmax weight

// Bytes of dynamic shared memory of flash_decode_tc: the ring (k and v
// tiles of TC_ROWS x D bf16 per stage), then q's fragments.
__host__ __device__ constexpr int tc_smem_bytes(int D, int nt, int q_parts) {
  return TC_STAGES * 2 * TC_ROWS * D * 2 + q_parts * nt * (D / 16) * 32 * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with bytes = 0 the destination
// is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// The 8x8 bf16 matrix whose row lane / 4, columns 2 (lane % 4) + {0, 1}
// this lane holds, transposed in the same layout.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// c += a . b, bf16 operands (m16n8k16), float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Part `part` of x's split into bf16 parts x = hi + mid + lo + ...: each
// part is the remainder so far rounded to bf16, the remainder exact in
// float32.
__device__ __forceinline__ float bf16_part(float x, int part) {
  float p = bf16_round(x);
  for (int i = 0; i < part; ++i) {
    x = x - p;
    p = bf16_round(x);
  }
  return p;
}

// Two bf16 values in one register, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Byte offset of 16-byte chunk c of row r in a ring tile of CH chunks a
// row, the chunk XOR-swizzled by the row so that the 8 rows one ldmatrix
// reads fall in distinct banks.
template <int CH>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  constexpr int SWZ = (CH < 8 ? CH : 8) - 1;
  return static_cast<uint32_t>((r * CH + (c ^ (r & SWZ))) * 16);
}

template <typename QT, int D, int NT, int QP>
__global__ void __launch_bounds__(TC_THREADS) flash_decode_tc(
    const QT* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc, int S,
    int G, int Hg, int split_len, float scale) {
  constexpr int CH = D / 8, KS = D / 16, HGP = 8 * NT;
  constexpr int TILE_BYTES = TC_ROWS * D * 2;  // k or v of one stage
  extern __shared__ __align__(128) unsigned char smem[];
  uint2* qfrag = reinterpret_cast<uint2*>(smem + TC_STAGES * 2 * TILE_BYTES);

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long part = ((long long)b * G + g) * gridDim.x + split;
  const int len = min(max(lengths[b], 0), S);
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  if (start >= end) {
    if (tid < Hg) {
      part_m[part * Hg + tid] = NEG_INF;
      part_l[part * Hg + tid] = 0.f;
    }
    return;
  }

  // The ring: tile t of the split goes to stage t % TC_STAGES.
  const long long row_stride = (long long)G * D;
  const __nv_bfloat16* kb = k + ((long long)b * S * G + g) * D;
  const __nv_bfloat16* vb = v + ((long long)b * S * G + g) * D;
  const int n_tiles = (end - start + TC_ROWS - 1) / TC_ROWS;
  const uint32_t ring = smem_addr(smem);
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const uint32_t st = ring + (t % TC_STAGES) * 2 * TILE_BYTES;
      const int row0 = start + t * TC_ROWS;
#pragma unroll 4
      for (int i = tid; i < TC_ROWS * CH; i += TC_THREADS) {
        const int r = i / CH, c = i % CH;
        const bool ok = row0 + r < end;
        const long long off = ok ? (row0 + r) * row_stride + c * 8 : 0;
        const uint32_t dst = st + tile_offset<CH>(r, c);
        cp_async16(dst, kb + off, ok ? 16 : 0);
        cp_async16(dst + TILE_BYTES, vb + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int t = 0; t < TC_STAGES - 1; ++t) load_tile(t);

  // q's B fragments, [part][n tile][k step][lane]: head nt * 8 + lane / 4,
  // columns d, d + 1 (.x) and d + 8, d + 9 (.y), d = 16 ks + 2 (lane % 4).
  // Heads Hg..HGP-1 hold 0; their scores are computed and never written.
  const QT* qg = q + ((long long)b * G + g) * Hg * D;
  for (int i = tid; i < QP * NT * KS * 32; i += TC_THREADS) {
    const int ln = i % 32, ks = (i / 32) % KS, nt = (i / (32 * KS)) % NT;
    const int qp = i / (32 * KS * NT);
    const int h = nt * 8 + ln / 4, d = ks * 16 + (ln % 4) * 2;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (h < Hg) {
      x[0] = to_float(qg[h * D + d]);
      x[1] = to_float(qg[h * D + d + 1]);
      x[2] = to_float(qg[h * D + d + 8]);
      x[3] = to_float(qg[h * D + d + 9]);
    }
    qfrag[i] = make_uint2(pack_bf16(bf16_part(x[0], qp), bf16_part(x[1], qp)),
                          pack_bf16(bf16_part(x[2], qp), bf16_part(x[3], qp)));
  }

  // This lane's state: heads nt * 8 + 2 (lane % 4) + j of the score and
  // accumulator fragments; acc[mt] holds O^T rows (d) 16 mt + lane / 4
  // and + 8.  l is the lane's partial sum over its own rows.
  float acc[KS][NT][4];
  float m[NT][2], l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m[nt][j] = NEG_INF;
      l[nt][j] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<TC_STAGES - 2>();  // tile t has landed (for this thread)
    __syncthreads();                 // ... for every thread; stage t - 1 is free
    load_tile(t + TC_STAGES - 1);
    const int wrow0 = start + t * TC_ROWS + warp * 16;
    if (wrow0 >= end) continue;  // this warp's rows all lie past the length
    const uint32_t ks_base = ring + (t % TC_STAGES) * 2 * TILE_BYTES;
    const uint32_t vs_base = ks_base + TILE_BYTES;

    // Scores S^T[16 rows x HGP heads] = K . q^T.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    const int ar = warp * 16 + lane % 16;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldmatrix_x4<false>(ks_base + tile_offset<CH>(ar, 2 * ks + lane / 16), a);
#pragma unroll
      for (int qp = 0; qp < QP; ++qp)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bq = qfrag[((qp * NT + nt) * KS + ks) * 32 + lane];
          mma_bf16(s[nt], a, bq.x, bq.y);
        }
    }

    // Online softmax per head column; rows lane / 4 and lane / 4 + 8.
    const bool valid0 = wrow0 + lane / 4 < end, valid1 = wrow0 + lane / 4 + 8 < end;
    uint32_t pb[P_PARTS][NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float a0 = valid0 ? s[nt][j] * scale : NEG_INF;
        const float a1 = valid1 ? s[nt][2 + j] * scale : NEG_INF;
        float tmax = fmaxf(a0, a1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(FULL_MASK, tmax, o));
        const float mx = fmaxf(m[nt][j], tmax);
        const float alpha = expf(m[nt][j] - mx);
        p[j] = valid0 ? expf(a0 - mx) : 0.f;
        p[2 + j] = valid1 ? expf(a1 - mx) : 0.f;
        l[nt][j] = l[nt][j] * alpha + (p[j] + p[2 + j]);
        m[nt][j] = mx;
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          acc[mt][nt][j] *= alpha;
          acc[mt][nt][2 + j] *= alpha;
        }
      }
      // P's B fragment: rows 2 (lane % 4) + {0, 1} (+ 8), head lane / 4.
#pragma unroll
      for (int pp = 0; pp < P_PARTS; ++pp) {
        pb[pp][nt][0] = transpose8x8(pack_bf16(bf16_part(p[0], pp), bf16_part(p[1], pp)));
        pb[pp][nt][1] = transpose8x8(pack_bf16(bf16_part(p[2], pp), bf16_part(p[3], pp)));
      }
    }

    // O^T[D x HGP] += V^T . P.
    const int vr = warp * 16 + (lane / 16) * 8 + lane % 8;
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      uint32_t a[4];
      ldmatrix_x4<true>(vs_base + tile_offset<CH>(vr, 2 * mt + (lane / 8) % 2), a);
#pragma unroll
      for (int pp = 0; pp < P_PARTS; ++pp)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, pb[pp][nt][0], pb[pp][nt][1]);
    }
  }

  // Merge the warps' states in shared memory (the ring, now idle) into the
  // block's partial.
  cp_async_wait<0>();
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(smem);  // [TC_WARPS][HGP][D]
  float* sm_m = sm_acc + TC_WARPS * HGP * D;        // [TC_WARPS][HGP]
  float* sm_l = sm_m + TC_WARPS * HGP;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float sum = l[nt][j];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(FULL_MASK, sum, o);
      if (lane < 4) {
        const int h = nt * 8 + 2 * lane + j;
        sm_m[warp * HGP + h] = m[nt][j];
        sm_l[warp * HGP + h] = sum;
      }
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      const int d = mt * 16 + lane / 4, h = nt * 8 + 2 * (lane % 4);
      float* o = sm_acc + (warp * HGP + h) * D + d;
      o[0] = acc[mt][nt][0];
      o[D] = acc[mt][nt][1];
      o[8] = acc[mt][nt][2];
      o[D + 8] = acc[mt][nt][3];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < Hg * D; idx += TC_THREADS) {
    const int h = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) mx = fmaxf(mx, sm_m[w * HGP + h]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w)
      a += sm_acc[(w * HGP + h) * D + d] * expf(sm_m[w * HGP + h] - mx);
    part_acc[part * Hg * D + idx] = a;
  }
  if (tid < Hg) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) mx = fmaxf(mx, sm_m[w * HGP + tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) sum += sm_l[w * HGP + tid] * expf(sm_m[w * HGP + tid] - mx);
    part_m[part * Hg + tid] = mx;
    part_l[part * Hg + tid] = sum;
  }
}

// Block-wide reduction of one value per thread (max or sum).
template <bool MAX>
__device__ float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(FULL_MASK, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = MAX ? NEG_INF : 0.f;
  for (int w = 0; w < COMBINE_THREADS / 32; ++w) x = MAX ? fmaxf(x, scratch[w]) : x + scratch[w];
  __syncthreads();  // scratch is reused by the next reduction
  return x;
}

template <typename OT>
__global__ void __launch_bounds__(COMBINE_THREADS) flash_decode_combine(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, OT* __restrict__ out, float* __restrict__ lse, int G,
    int Hg, int D, int n_splits) {
  extern __shared__ float weight[];  // [n_splits]: exp(m_s - max), 0 for an empty split
  __shared__ float scratch[COMBINE_THREADS / 32];
  const int h = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const long long first = ((long long)b * G + g) * n_splits;
  float mx = NEG_INF;
  for (int s = threadIdx.x; s < n_splits; s += COMBINE_THREADS)
    mx = fmaxf(mx, part_m[(first + s) * Hg + h]);
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.f;
  for (int s = threadIdx.x; s < n_splits; s += COMBINE_THREADS) {
    const float ls = part_l[(first + s) * Hg + h];
    // an empty split (l = 0) left its acc unwritten
    const float w = ls > 0.f ? expf(part_m[(first + s) * Hg + h] - mx) : 0.f;
    weight[s] = w;
    sum += ls * w;
  }
  sum = block_reduce<false>(sum, scratch);  // its barrier also publishes weight[]
  // the log-sum-exp of the scaled scores over the valid rows; -inf for none
  if (lse != nullptr && threadIdx.x == 0)
    lse[((long long)b * G + g) * Hg + h] =
        sum > 0.f ? mx + logf(sum) : __int_as_float(0xff800000);  // -inf
  for (int d = threadIdx.x; d < D; d += COMBINE_THREADS) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      if (weight[s] > 0.f) a += part_acc[((first + s) * Hg + h) * D + d] * weight[s];
    out[((long long)b * G + g) * Hg * D + h * D + d] = from_float<OT>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename OT>
cudaError_t launch_combine(const float* part_m, const float* part_l, const float* part_acc,
                           void* out, float* lse, int B, int G, int Hg, int D, int n_splits,
                           cudaStream_t stream) {
  flash_decode_combine<OT>
      <<<dim3(Hg, G, B), COMBINE_THREADS, n_splits * sizeof(float), stream>>>(
          part_m, part_l, part_acc, static_cast<OT*>(out), lse, G, Hg, D, n_splits);
  return cudaGetLastError();
}

template <typename QT, typename KT, int VEC, int HG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   float* part_m, float* part_l, float* part_acc, int B, int S,
                   int G, int Hg, int D, int Dv, int split_len, int n_splits, float scale,
                   cudaStream_t stream) {
  flash_decode_partial<QT, KT, VEC, HG><<<dim3(n_splits, G, B), THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), lengths,
      part_m, part_l, part_acc, S, G, Hg, D, Dv, split_len, scale);
  return cudaGetLastError();
}

template <typename QT, int D, int NT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const int* lengths,
                      float* part_m, float* part_l, float* part_acc, int B, int S,
                      int G, int Hg, int split_len, int n_splits, float scale,
                      cudaStream_t stream) {
  constexpr int QP = sizeof(QT) == 4 ? 3 : 1;  // bf16 parts of q
  constexpr int smem = tc_smem_bytes(D, NT, QP);
  auto kernel = flash_decode_tc<QT, D, NT, QP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_splits, G, B), TC_THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part_m, part_l, part_acc, S, G, Hg,
      split_len, scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_tc_shape(const void* q, const void* k, const void* v, const int* lengths,
                            float* part_m, float* part_l, float* part_acc, int B,
                            int S, int G, int Hg, int D, int split_len, int n_splits,
                            float scale, cudaStream_t stream) {
  if (Hg < 1 || Hg > 16 || split_len % TC_ROWS) return cudaErrorInvalidValue;
#define FLASH_DECODE_TC(DV)                                                                 \
  case DV:                                                                                  \
    return Hg <= 8 ? launch_tc<QT, DV, 1>(q, k, v, lengths, part_m, part_l, part_acc, \
                                          B, S, G, Hg, split_len, n_splits, scale, stream)  \
                   : launch_tc<QT, DV, 2>(q, k, v, lengths, part_m, part_l, part_acc, \
                                          B, S, G, Hg, split_len, n_splits, scale, stream);
  switch (D) {
    FLASH_DECODE_TC(16)
    FLASH_DECODE_TC(32)
    FLASH_DECODE_TC(64)
    FLASH_DECODE_TC(128)
    FLASH_DECODE_TC(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_DECODE_TC
}

// The tensor-core kernel for q of type QT, head dim D and nt head tiles
// (nullptr for a shape it does not take).
template <typename QT>
const void* tc_kernel(int D, int nt) {
  constexpr int QP = sizeof(QT) == 4 ? 3 : 1;
#define FLASH_DECODE_TC_FN(DV)                                             \
  case DV:                                                                 \
    return nt == 1 ? reinterpret_cast<const void*>(flash_decode_tc<QT, DV, 1, QP>) \
                   : reinterpret_cast<const void*>(flash_decode_tc<QT, DV, 2, QP>);
  if (nt != 1 && nt != 2) return nullptr;
  switch (D) {
    FLASH_DECODE_TC_FN(16)
    FLASH_DECODE_TC_FN(32)
    FLASH_DECODE_TC_FN(64)
    FLASH_DECODE_TC_FN(128)
    FLASH_DECODE_TC_FN(256)
    default:
      return nullptr;
  }
#undef FLASH_DECODE_TC_FN
}

// Hg rounded up to a power of two, the register arrays' size; 0 where a
// lane's q and accumulators would not fit (Hg > 16 or HG * D > 2048).
int group_size(int Hg, int vec) {
  int hg = 1;
  while (hg < Hg) hg *= 2;
  return (hg <= MAX_HEADS && hg * 32 * vec <= GROUP_FLOATS) ? hg : 0;
}

template <typename QT, typename KT, int VEC>
cudaError_t launch_group(const void* q, const void* k, const void* v, const int* lengths,
                         float* part_m, float* part_l, float* part_acc, int B,
                         int S, int G, int Hg, int D, int Dv, int split_len, int n_splits,
                         float scale, cudaStream_t stream) {
#define FLASH_DECODE_HG(HGV)                                                                \
  case HGV:                                                                                 \
    if constexpr (HGV * 32 * VEC <= GROUP_FLOATS)                                           \
      return launch<QT, KT, VEC, HGV>(q, k, v, lengths, part_m, part_l, part_acc, B, \
                                      S, G, Hg, D, Dv, split_len, n_splits, scale, stream); \
    return cudaErrorInvalidValue;
  switch (group_size(Hg, VEC)) {
    FLASH_DECODE_HG(1)
    FLASH_DECODE_HG(2)
    FLASH_DECODE_HG(4)
    FLASH_DECODE_HG(8)
    FLASH_DECODE_HG(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_DECODE_HG
}

template <typename QT, typename KT>
cudaError_t launch_vec(int vec, const void* q, const void* k, const void* v,
                       const int* lengths, float* part_m, float* part_l, float* part_acc,
                       int B, int S, int G, int Hg, int D, int Dv, int split_len,
                       int n_splits, float scale, cudaStream_t stream) {
#define FLASH_DECODE_VEC(V)                                                             \
  case V:                                                                               \
    return launch_group<QT, KT, V>(q, k, v, lengths, part_m, part_l, part_acc, B, \
                                   S, G, Hg, D, Dv, split_len, n_splits, scale, stream);
  switch (vec) {
    FLASH_DECODE_VEC(1)
    FLASH_DECODE_VEC(2)
    FLASH_DECODE_VEC(4)
    FLASH_DECODE_VEC(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_DECODE_VEC
}

}  // namespace

extern "C" {

// 1 if the CUDA-core body takes Hg query heads per group at vec = D / 32
// elements a lane (1 when D <= 32), else 0.
int flash_decode_supported(int Hg, int vec) { return group_size(Hg, vec) > 0; }

// The most splits of S one launch takes.
int flash_decode_max_splits() { return MAX_SPLITS; }

// Rows of one ring stage of the tensor-core body; its splits are a
// multiple of them.
int flash_decode_tc_rows() { return TC_ROWS; }

// Dynamic shared memory of the tensor-core body for q of dtype code
// q_dtype (0 float32, 1 bfloat16), Hg heads a group and head dim D.
int flash_decode_tc_smem(int q_dtype, int Hg, int D) {
  return tc_smem_bytes(D, Hg <= 8 ? 1 : 2, q_dtype == 0 ? 3 : 1);
}

// Registers a thread of the tensor-core kernel for that shape takes, or
// -1 where it has none or the query fails.
int flash_decode_tc_regs(int q_dtype, int Hg, int D) {
  const int nt = Hg <= 8 ? 1 : 2;
  const void* fn = q_dtype == 0 ? tc_kernel<float>(D, nt) : tc_kernel<__nv_bfloat16>(D, nt);
  cudaFuncAttributes attr;
  if (fn == nullptr || cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  return attr.numRegs;
}

namespace {

// The splits' partials of one launch: the body flash_decode picks.
cudaError_t launch_partials(int tensor_cores, int q_dtype, int kv_dtype, int vec, const void* q,
                            const void* k, const void* v, const int* len, float* pm, float* pl,
                            float* pa, int B, int S, int G, int Hg, int D, int Dv,
                            int split_len, int n_splits, float scale, cudaStream_t st) {
  if (Dv < 1 || Dv > D || D % Dv) return cudaErrorInvalidValue;
  if (tensor_cores) {
    if (kv_dtype != 1 || Dv != D) return cudaErrorInvalidValue;
    if (q_dtype == 0)
      return launch_tc_shape<float>(q, k, v, len, pm, pl, pa, B, S, G, Hg, D, split_len,
                                    n_splits, scale, st);
    if (q_dtype == 1)
      return launch_tc_shape<__nv_bfloat16>(q, k, v, len, pm, pl, pa, B, S, G, Hg, D,
                                            split_len, n_splits, scale, st);
    return cudaErrorInvalidValue;
  }
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_vec<float, float>(vec, q, k, v, len, pm, pl, pa, B, S, G, Hg, D, Dv,
                                    split_len, n_splits, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_vec<float, __nv_bfloat16>(vec, q, k, v, len, pm, pl, pa, B, S, G, Hg,
                                            D, Dv, split_len, n_splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, q, k, v, len, pm, pl, pa, B, S,
                                                    G, Hg, D, Dv, split_len, n_splits, scale,
                                                    st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Hg * G, D] (dtype code 0 float32, 1 bfloat16), k [B, S, G, D] and
// v the columns c .. c + Dv - 1 of a [B, S, G, D] tensor strided as k (v
// points at column c; Dv divides D, Dv = D the whole of it; same codes;
// bfloat16 q takes a bfloat16 cache only), lengths int32 [B]; scratch
// part_m, part_l float32 [B, G, n_splits, Hg] and part_acc
// [B, G, n_splits, Hg, Dv].  n_splits * split_len >= S.
// tensor_cores = 1 runs the tensor-core body (a bfloat16 cache, D in
// {16, 32, 64, 128, 256}, Hg <= 16, split_len a multiple of TC_ROWS, Dv =
// D), 0 the CUDA-core body; then the combine writes out [B, Hg * G, Dv], like q
// or, with out_f32 = 1, float32, and, where lse is not null, the float32
// log-sum-exp [B, Hg * G] of each head's scaled scores over its valid rows
// (-inf where a sequence has none): the sequence-split entry, whose
// partial results of several row blocks merge by their lse.  Returns the
// first CUDA error of the launches, or 0; a shape the chosen body does not
// take returns cudaErrorInvalidValue without launching.
int flash_decode(int tensor_cores, int q_dtype, int kv_dtype, int vec, const void* q,
                 const void* k, const void* v, const void* lengths, void* part_m, void* part_l,
                 void* part_acc, void* out, int B, int S, int G, int Hg, int D, int Dv,
                 int split_len, int n_splits, float scale, int out_f32, void* lse,
                 void* stream) {
  float *pm = static_cast<float*>(part_m), *pl = static_cast<float*>(part_l),
        *pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_partials(tensor_cores, q_dtype, kv_dtype, vec, q, k, v,
                                    static_cast<const int*>(lengths), pm, pl, pa, B, S, G, Hg,
                                    D, Dv, split_len, n_splits, scale, st);
  if (err != cudaSuccess) return err;
  float* l = static_cast<float*>(lse);
  if (out_f32 || q_dtype == 0)
    return launch_combine<float>(pm, pl, pa, out, l, B, G, Hg, Dv, n_splits, st);
  return launch_combine<__nv_bfloat16>(pm, pl, pa, out, l, B, G, Hg, Dv, n_splits, st);
}

}  // extern "C"
