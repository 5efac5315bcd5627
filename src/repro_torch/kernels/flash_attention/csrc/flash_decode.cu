// GQA flash decode attention for Hopper (sm_90a): one query token per
// sequence attends over the first lengths[b] rows of its k/v cache.
//
// Replaces the reference's Pallas TPU kernel `flash_decode`
// (src/repro/kernels/flash_attention/flash_kernel.py, `_decode_body`).
// The TPU kernel walks the cache's S axis in order on one core, carrying
// the online-softmax state (m, l, acc) in VMEM scratch from chunk to
// chunk.  On the H100 a block per (b, g) would fill only B * G of the 132
// SMs (8 for gemma-2b in the serving engine), so this is flash-decoding
// instead:
//
//   flash_decode_partial  one block per (split of S, kv group g, sequence
//                         b).  Each of its warps takes two rows of the
//                         split at a time (every WARPS-th row); a lane
//                         holds D / 32 contiguous elements of the group's
//                         Hg query rows and of their running numerators
//                         in registers, loads its slice of the next two k
//                         and v rows while it works on the current ones,
//                         reduces each q.k score across the warp with
//                         shuffles and updates the online softmax without
//                         a branch, so the heads' and rows' work overlaps
//                         (a branch on each head's running max would run
//                         the heads one after another).  The warps'
//                         (m, l, acc) merge in shared memory into one
//                         partial per block, written to float32 scratch
//                         that the wrapper allocates.  A split that lies
//                         wholly past lengths[b] writes an empty partial
//                         (m = -1e30, l = 0) without reading k or v.
//   flash_decode_combine  one block per (head, g, b) merges the splits'
//                         partials (their weights exp(m_s - max) computed
//                         once, in shared memory) and writes
//                         acc / max(l, 1e-30) in q's dtype, so a
//                         sequence with no valid row gives exactly 0, as
//                         the Pallas kernel's denominator floor does.
//
// Arithmetic follows the Pallas body: scores (q . k) * D^-0.5, softmax
// weights and sums in float32 (expf, IEEE division, no fast math), the
// output cast once at the end.  Only the summation order differs.
//
// Bound: the bytes of k and v up to lengths[b] (each read once); at the
// `decode_32k` shape of one gemma-2b layer (B 128, S 32768, G 1, D 256,
// bf16) that is 4.29 GB, 1.28 ms at 3.35 TB/s.  The scores and the
// weighted sum cost 2 * Hg * D multiply-adds per row on the CUDA cores,
// ~4 per byte at Hg = 8, under the fp32 rate but not far under it; a
// later tensor-core (wgmma) and TMA version is where that goes.
//
// Plain C interface, built by kernels/build.py with nvcc and bound with
// ctypes.  Every launch is checked with cudaGetLastError and the error is
// returned to the wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int COMBINE_THREADS = 256;
// HG * 32 * VEC <= GROUP_FLOATS and HG <= MAX_HEADS, HG the query heads
// of a group rounded up to a power of two: a lane holds at most 64 query
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
    float* __restrict__ part_acc, int S, int G, int Hg, int D, int split_len, float scale) {
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
  const KT* vb = v + ((long long)b * S * G + g) * D + d0;
  auto fetch = [&](int row, P& kr, P& vr) {
    if (row < end && active) {
      kr = *reinterpret_cast<const P*>(kb + row * row_stride);
      vr = *reinterpret_cast<const P*>(vb + row * row_stride);
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
      vf1[i] = active ? to_float(v1.v[i]) : 0.f;
      kf2[i] = (active && second) ? to_float(k2.v[i]) : 0.f;
      vf2[i] = (active && second) ? to_float(v2.v[i]) : 0.f;
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
      if (active) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) sm_acc[warp][h * D + d0 + i] = acc[h][i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Hg * D; idx += THREADS) {
    const int h = idx / D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][h]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sm_acc[w][idx] * expf(sm_m[w][h] - mx);
    part_acc[part * Hg * D + idx] = a;
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
    const float* __restrict__ part_acc, OT* __restrict__ out, int G, int Hg, int D,
    int n_splits) {
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
  for (int d = threadIdx.x; d < D; d += COMBINE_THREADS) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s)
      if (weight[s] > 0.f) a += part_acc[((first + s) * Hg + h) * D + d] * weight[s];
    out[((long long)b * G + g) * Hg * D + h * D + d] = from_float<OT>(a / fmaxf(sum, 1e-30f));
  }
}

template <typename QT, typename KT, int VEC, int HG>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   float* part_m, float* part_l, float* part_acc, void* out, int B, int S,
                   int G, int Hg, int D, int split_len, int n_splits, float scale,
                   cudaStream_t stream) {
  flash_decode_partial<QT, KT, VEC, HG><<<dim3(n_splits, G, B), THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), lengths,
      part_m, part_l, part_acc, S, G, Hg, D, split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine<QT>
      <<<dim3(Hg, G, B), COMBINE_THREADS, n_splits * sizeof(float), stream>>>(
          part_m, part_l, part_acc, static_cast<QT*>(out), G, Hg, D, n_splits);
  return cudaGetLastError();
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
                         float* part_m, float* part_l, float* part_acc, void* out, int B,
                         int S, int G, int Hg, int D, int split_len, int n_splits, float scale,
                         cudaStream_t stream) {
#define FLASH_DECODE_HG(HGV)                                                                \
  case HGV:                                                                                 \
    if constexpr (HGV * 32 * VEC <= GROUP_FLOATS)                                           \
      return launch<QT, KT, VEC, HGV>(q, k, v, lengths, part_m, part_l, part_acc, out, B, \
                                      S, G, Hg, D, split_len, n_splits, scale, stream);     \
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
                       void* out, int B, int S, int G, int Hg, int D, int split_len,
                       int n_splits, float scale, cudaStream_t stream) {
#define FLASH_DECODE_VEC(V)                                                             \
  case V:                                                                               \
    return launch_group<QT, KT, V>(q, k, v, lengths, part_m, part_l, part_acc, out, B, \
                                   S, G, Hg, D, split_len, n_splits, scale, stream);
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

// 1 if the kernel takes Hg query heads per group at vec = D / 32 elements
// a lane (1 when D <= 32), else 0.
int flash_decode_supported(int Hg, int vec) { return group_size(Hg, vec) > 0; }

// The most splits of S one launch takes.
int flash_decode_max_splits() { return MAX_SPLITS; }

// q [B, Hg * G, D] (dtype code 0 float32, 1 bfloat16), k and v [B, S, G, D]
// (same codes; bfloat16 q takes a bfloat16 cache only), lengths int32 [B];
// scratch part_m, part_l float32 [B, G, n_splits, Hg] and part_acc
// [B, G, n_splits, Hg, D]; out like q.  n_splits * split_len >= S.
// Returns the first CUDA error of the two launches, or 0.
int flash_decode(int q_dtype, int kv_dtype, int vec, const void* q, const void* k,
                 const void* v, const void* lengths, void* part_m, void* part_l,
                 void* part_acc, void* out, int B, int S, int G, int Hg, int D, int split_len,
                 int n_splits, float scale, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  float *pm = static_cast<float*>(part_m), *pl = static_cast<float*>(part_l),
        *pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_vec<float, float>(vec, q, k, v, len, pm, pl, pa, out, B, S, G, Hg, D,
                                    split_len, n_splits, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_vec<float, __nv_bfloat16>(vec, q, k, v, len, pm, pl, pa, out, B, S, G, Hg,
                                            D, split_len, n_splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, q, k, v, len, pm, pl, pa, out, B, S,
                                                    G, Hg, D, split_len, n_splits, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
