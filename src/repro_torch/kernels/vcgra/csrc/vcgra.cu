// Hand-written Hopper (sm_90a) kernels for the conventional VCGRA overlay
// (settings as runtime data).
//
// Replaces three Pallas TPU kernels of the JAX reference package:
//   * vcgra_fused_batched_kernel  <- src/repro/kernels/vcgra/vcgra_kernel.py:
//     vcgra_fused_batched (body _fused_batched_body): N raw frames, N tenants'
//     settings banks, tap bank + channel select + L PE levels + K output muxes
//     in one launch;
//   * vcgra_batched_kernel        <- src/repro/kernels/vcgra/vcgra_kernel.py:
//     vcgra_batched (body _batched_body): the same level pipeline over
//     pre-packed channels [N, C, B];
//   * vcgra_conventional_kernel   <- src/repro/kernels/vcgra/vcgra_kernel.py:
//     vcgra_conventional (body _conventional_body, _level_pipeline): one app,
//     one settings bank, channel-major [C, N] -- B2's pipeline with block_n
//     pixels per block, so a block stages its bank once for block_n / 128
//     passes of its threads.
//
// What bounds it on the H100: memory bytes.  Each pixel reads one frame value
// per tap (served from L1/L2: neighbouring threads share taps) and writes K
// outputs; the PE work is sum(pes_per_level) scalar ops per pixel, far below
// the card's scalar rate at 3.35 TB/s.  The mux is a data-dependent gather
// over the pixel's value vector, which a register file cannot index, so the
// design keeps each thread's value vector in a shared-memory column
// (vals[slot][threadIdx.x]): a VC mux select becomes one shared-memory read,
// conflict-free because the threads of a warp read consecutive words.
//
// Design (right before fast):
//   * grid (pixel blocks, N apps); each block stages its app's settings rows
//     (ops, sel, out_sel, tap_sel, const, level widths) in shared memory, the
//     counterpart of the TPU kernel's scalar-prefetched SMEM banks;
//   * one thread per pixel: channels are read straight from the canvas (tap
//     t -> (dj, di) in tap_offsets row-major order; reads outside
//     [0,H) x [0,W) are 0), so the output does not depend on the plan's row
//     tile height and no halo tensor is ever materialized;
//   * 64-bit index math for N*K*H*W;
//   * PE semantics are the reference's bit for bit (vcgra_pe.cuh).
// wgmma, TMA and occupancy work are left for later.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include "vcgra_pe.cuh"

namespace {

constexpr int kBlock = 128;   // threads (= pixels) per block
constexpr int kMaxVals = 32;  // widest value vector: max(C, pes per level)

// --- settings staging ------------------------------------------------------

struct Settings {
  const int* ops;      // [L, max_w]
  const int* sel;      // [L, max_w, 2]
  const int* out_sel;  // [K]
  const int* widths;   // [L]
  const int* tap_sel;  // [C] (fused only)
};

// Copy app n's settings rows into shared memory: one bank per block, read by
// every thread's mux selects.
template <typename T>
__device__ Settings stage_settings(int* smem, const int* ops, const int* sel,
                                   const int* out_sel, const int* widths,
                                   const int* tap_sel, const T* consts,
                                   T* s_consts, int n, int L, int max_w, int K, int C) {
  const int n_ops = L * max_w;
  int* s_ops = smem;
  int* s_sel = s_ops + n_ops;
  int* s_out = s_sel + 2 * n_ops;
  int* s_w = s_out + K;
  int* s_tap = s_w + L;
  const int64_t app = n;
  for (int i = threadIdx.x; i < n_ops; i += blockDim.x) s_ops[i] = ops[app * n_ops + i];
  for (int i = threadIdx.x; i < 2 * n_ops; i += blockDim.x)
    s_sel[i] = sel[app * 2 * n_ops + i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) s_out[i] = out_sel[app * K + i];
  for (int i = threadIdx.x; i < L; i += blockDim.x) s_w[i] = widths[i];
  if (tap_sel != nullptr) {
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      s_tap[i] = tap_sel[app * C + i];
      s_consts[i] = consts[app * C + i];
    }
  }
  __syncthreads();
  return Settings{s_ops, s_sel, s_out, s_w, s_tap};
}

// Run the L PE levels over this thread's value column (vals[0] holds the C
// channels on entry) and write the K output-mux selections.
template <typename T>
__device__ void level_pipeline(const Settings& s, T (*vals)[kMaxVals][kBlock],
                               int L, int max_w, int K, T* out, int64_t out_base,
                               int64_t stride, bool active) {
  const int tid = threadIdx.x;
  int cur = 0;
  for (int lvl = 0; lvl < L; ++lvl) {
    const int w = s.widths[lvl];
    const int* ops = s.ops + lvl * max_w;
    const int* sel = s.sel + 2 * lvl * max_w;
    for (int slot = 0; slot < w; ++slot) {
      const T a = vals[cur][sel[2 * slot]][tid];
      const T b = vals[cur][sel[2 * slot + 1]][tid];
      vals[1 - cur][slot][tid] = pe(ops[slot], a, b);
    }
    cur = 1 - cur;
  }
  if (!active) return;
  for (int k = 0; k < K; ++k) out[out_base + k * stride] = vals[cur][s.out_sel[k]][tid];
}

// --- B1: fused-ingest megakernel ------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBlock)
vcgra_fused_batched_kernel(const T* __restrict__ frames, const int* __restrict__ ops,
                           const int* __restrict__ sel, const int* __restrict__ out_sel,
                           const int* __restrict__ tap_sel, const T* __restrict__ consts,
                           const int* __restrict__ widths, T* __restrict__ out,
                           int H, int W, int L, int max_w, int K, int C, int radius) {
  extern __shared__ int smem[];
  // Raw storage: a __shared__ array may not have a constructor (bf16).
  __shared__ __align__(16) unsigned char vals_raw[2 * kMaxVals * kBlock * sizeof(T)];
  __shared__ __align__(16) unsigned char consts_raw[kMaxVals * sizeof(T)];
  auto vals = reinterpret_cast<T (*)[kMaxVals][kBlock]>(vals_raw);
  T* s_consts = reinterpret_cast<T*>(consts_raw);
  const int n = blockIdx.y;
  const Settings s = stage_settings<T>(smem, ops, sel, out_sel, widths, tap_sel, consts,
                                       s_consts, n, L, max_w, K, C);
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool active = p < hw;
  const int y = active ? static_cast<int>(p / W) : 0;
  const int x = active ? static_cast<int>(p % W) : 0;
  const int side = 2 * radius + 1;
  const int zero_row = side * side;
  const T* frame = frames + static_cast<int64_t>(n) * hw;
  for (int c = 0; c < C; ++c) {
    const int t = s.tap_sel[c];
    T v = zero_value<T>();
    if (t == zero_row) {
      v = s_consts[c];
    } else if (active && t >= 0 && t < zero_row) {
      const int yy = y + t / side - radius;
      const int xx = x + t % side - radius;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = frame[static_cast<int64_t>(yy) * W + xx];
    }
    vals[0][c][threadIdx.x] = v;
  }
  level_pipeline<T>(s, vals, L, max_w, K, out,
                    static_cast<int64_t>(n) * K * hw + p, hw, active);
}

// --- B2: pre-packed channels ------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBlock)
vcgra_batched_kernel(const T* __restrict__ xs, const int* __restrict__ ops,
                     const int* __restrict__ sel, const int* __restrict__ out_sel,
                     const int* __restrict__ widths, T* __restrict__ out,
                     int64_t B, int L, int max_w, int K, int C) {
  extern __shared__ int smem[];
  __shared__ __align__(16) unsigned char vals_raw[2 * kMaxVals * kBlock * sizeof(T)];
  auto vals = reinterpret_cast<T (*)[kMaxVals][kBlock]>(vals_raw);
  const int n = blockIdx.y;
  const Settings s = stage_settings<T>(smem, ops, sel, out_sel, widths, nullptr,
                                       static_cast<const T*>(nullptr), nullptr,
                                       n, L, max_w, K, C);
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const bool active = p < B;
  const T* x = xs + static_cast<int64_t>(n) * C * B;
  for (int c = 0; c < C; ++c)
    vals[0][c][threadIdx.x] = active ? x[c * B + p] : zero_value<T>();
  level_pipeline<T>(s, vals, L, max_w, K, out, static_cast<int64_t>(n) * K * B + p, B,
                    active);
}

// --- B4: one app over channel-major [C, N] ---------------------------------

template <typename T>
__global__ void __launch_bounds__(kBlock)
vcgra_conventional_kernel(const T* __restrict__ x, const int* __restrict__ ops,
                          const int* __restrict__ sel, const int* __restrict__ out_sel,
                          const int* __restrict__ widths, T* __restrict__ out, int64_t N,
                          int64_t block_n, int L, int max_w, int K, int C) {
  extern __shared__ int smem[];
  __shared__ __align__(16) unsigned char vals_raw[2 * kMaxVals * kBlock * sizeof(T)];
  auto vals = reinterpret_cast<T (*)[kMaxVals][kBlock]>(vals_raw);
  const Settings s = stage_settings<T>(smem, ops, sel, out_sel, widths, nullptr,
                                       static_cast<const T*>(nullptr), nullptr,
                                       0, L, max_w, K, C);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * block_n;
  const int64_t end = start + block_n < N ? start + block_n : N;
  // Each pass is independent per thread (its own value column), so passes
  // need no barrier between them.
  for (int64_t base = start; base < end; base += kBlock) {
    const int64_t p = base + threadIdx.x;
    const bool active = p < end;
    for (int c = 0; c < C; ++c)
      vals[0][c][threadIdx.x] = active ? x[c * N + p] : zero_value<T>();
    level_pipeline<T>(s, vals, L, max_w, K, out, p, N, active);
  }
}

size_t settings_smem_bytes(int L, int max_w, int K, int C) {
  return sizeof(int) * (static_cast<size_t>(3) * L * max_w + K + L + C);
}

template <typename T>
int launch_fused(const void* frames, const int* ops, const int* sel, const int* out_sel,
                 const int* tap_sel, const void* consts, const int* widths, void* out,
                 int N, int H, int W, int L, int max_w, int K, int C, int radius,
                 cudaStream_t stream) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((hw + kBlock - 1) / kBlock), N);
  vcgra_fused_batched_kernel<T><<<grid, kBlock, settings_smem_bytes(L, max_w, K, C), stream>>>(
      static_cast<const T*>(frames), ops, sel, out_sel, tap_sel,
      static_cast<const T*>(consts), widths, static_cast<T*>(out), H, W, L, max_w, K, C,
      radius);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_batched(const void* xs, const int* ops, const int* sel, const int* out_sel,
                   const int* widths, void* out, int N, int64_t B, int L, int max_w, int K,
                   int C, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((B + kBlock - 1) / kBlock), N);
  vcgra_batched_kernel<T><<<grid, kBlock, settings_smem_bytes(L, max_w, K, 0), stream>>>(
      static_cast<const T*>(xs), ops, sel, out_sel, widths, static_cast<T*>(out), B, L,
      max_w, K, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_conventional(const void* x, const int* ops, const int* sel, const int* out_sel,
                        const int* widths, void* out, int64_t N, int64_t block_n, int L,
                        int max_w, int K, int C, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((N + block_n - 1) / block_n));
  vcgra_conventional_kernel<T><<<grid, kBlock, settings_smem_bytes(L, max_w, K, 0), stream>>>(
      static_cast<const T*>(x), ops, sel, out_sel, widths, static_cast<T*>(out), N, block_n,
      L, max_w, K, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 int32, 1 int16, 2 float32, 3 bfloat16.  A bad code returns
// cudaErrorInvalidValue without launching.
extern "C" int vcgra_max_vals() { return kMaxVals; }

extern "C" int vcgra_fused_batched(int dtype, const void* frames, const int* ops,
                                   const int* sel, const int* out_sel, const int* tap_sel,
                                   const void* consts, const int* widths, void* out, int N,
                                   int H, int W, int L, int max_w, int K, int C, int radius,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fused<int32_t>(frames, ops, sel, out_sel, tap_sel, consts, widths,
                                         out, N, H, W, L, max_w, K, C, radius, st);
    case 1: return launch_fused<int16_t>(frames, ops, sel, out_sel, tap_sel, consts, widths,
                                         out, N, H, W, L, max_w, K, C, radius, st);
    case 2: return launch_fused<float>(frames, ops, sel, out_sel, tap_sel, consts, widths,
                                       out, N, H, W, L, max_w, K, C, radius, st);
    case 3: return launch_fused<__nv_bfloat16>(frames, ops, sel, out_sel, tap_sel, consts,
                                               widths, out, N, H, W, L, max_w, K, C, radius,
                                               st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int vcgra_batched(int dtype, const void* xs, const int* ops, const int* sel,
                             const int* out_sel, const int* widths, void* out, int N,
                             int64_t B, int L, int max_w, int K, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_batched<int32_t>(xs, ops, sel, out_sel, widths, out, N, B, L,
                                           max_w, K, C, st);
    case 1: return launch_batched<int16_t>(xs, ops, sel, out_sel, widths, out, N, B, L,
                                           max_w, K, C, st);
    case 2: return launch_batched<float>(xs, ops, sel, out_sel, widths, out, N, B, L, max_w,
                                         K, C, st);
    case 3: return launch_batched<__nv_bfloat16>(xs, ops, sel, out_sel, widths, out, N, B,
                                                 L, max_w, K, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// block_n: pixels per block, a positive multiple of the block's 128 threads
// (the wrapper checks it); any other value returns cudaErrorInvalidValue.
extern "C" int vcgra_conventional(int dtype, const void* x, const int* ops, const int* sel,
                                  const int* out_sel, const int* widths, void* out,
                                  int64_t N, int64_t block_n, int L, int max_w, int K, int C,
                                  void* stream) {
  if (block_n <= 0 || block_n % kBlock != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_conventional<int32_t>(x, ops, sel, out_sel, widths, out, N, block_n,
                                                L, max_w, K, C, st);
    case 1: return launch_conventional<int16_t>(x, ops, sel, out_sel, widths, out, N, block_n,
                                                L, max_w, K, C, st);
    case 2: return launch_conventional<float>(x, ops, sel, out_sel, widths, out, N, block_n,
                                              L, max_w, K, C, st);
    case 3: return launch_conventional<__nv_bfloat16>(x, ops, sel, out_sel, widths, out, N,
                                                      block_n, L, max_w, K, C, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
