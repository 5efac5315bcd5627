// Hand-written Hopper (sm_90a) kernels for the conventional VCGRA overlay
// (settings as runtime data).
//
// Replaces three Pallas TPU kernels of the JAX reference package:
//   * B1 vcgra_fused_batched  <- src/repro/kernels/vcgra/vcgra_kernel.py:
//     vcgra_fused_batched (body _fused_batched_body): N raw frames, N tenants'
//     settings banks, tap bank + channel select + L PE levels + K output muxes
//     in one call;
//   * B2 vcgra_batched        <- src/repro/kernels/vcgra/vcgra_kernel.py:
//     vcgra_batched (body _batched_body): the same level pipeline over
//     pre-packed channels [N, C, B];
//   * B4 vcgra_conventional   <- src/repro/kernels/vcgra/vcgra_kernel.py:
//     vcgra_conventional (body _conventional_body, _level_pipeline): one app,
//     one settings bank, channel-major [C, N].
//
// What bounds them on the H100.  B1: instruction issue, not bytes -- each
// pixel reads its frame once and writes K outputs, ~0.08 ms of bytes at
// the main path's shape, but every live PE at every pixel is a
// runtime-selected op on two runtime-selected values, which a register
// file cannot index.  B2 and B4 read a channel row per live channel a
// pixel, so their bytes weigh more: they run near them.  All three take
// the vectorised design of vcgra_vec.cuh (shared with B3): P = 16 /
// sizeof(T) pixels a thread in 16-byte shared-memory value columns;
// settings decoded once per app by a first one-warp launch
// (vcgra_pack_settings) into a record of the live PEs and live channels
// only; one pe_vec call site with the next PE prefetched; no division or
// modulo per pixel.
//   * B1 is the tile kernel's one-stage instance: one block per (app,
//     32 x 32P output tile) with the (32 + 2r) x (32P + 2r) frame window in
//     shared memory and taps at precomputed offsets dy * row + dx, for r up
//     to kMaxWindowRadius (16).  A larger radius takes the same kernel
//     without the window (vcgra_tile_kernel<T, false, false, ...>): each
//     tap is read from the frame in device memory, still P pixels a
//     thread.  The wrapper (ops.fused_launch) picks the path from the
//     radius.
//   * B2: each block stages its app's record once and then takes
//     kBatchedPasses groups of P pixels a thread, reading each live
//     channel's row x[c * B + p ...] with one 16-byte load where the rows
//     are 16-byte aligned (B a multiple of P), P scalar loads otherwise.
//   * B4 is B2's kernel over one app ([C, N] is [1, C, B]) with the passes
//     a runtime argument: block_n pixels a block, so ceil(block_n /
//     (threads * P)) passes, at least one.  The reference's block_n
//     contract holds (a positive multiple of 128); the output does not
//     depend on it.  Its block (the sobel_mag grid's 45 value slots a
//     thread) fits two to an SM, so on aligned rows it copies a group's
//     live channels into shared memory with cp.async, all in flight at
//     once, instead of two loads at a time through registers.
//
// Any value width: past what a 64-thread block holds in shared memory
// (ops._block), each kernel takes its kDeviceBanks instance, value banks
// in a device-memory scratch of the resident blocks (`vals`, bank_blocks
// of them) and a grid-stride loop over the work.
//
// PE semantics are vcgra_pe.cuh's (bit for bit the reference's).  64-bit
// index math for N*K*H*W.
//
// C interface (bound with ctypes): every entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError() (or the error of
// the shared-memory attribute call).

#include "vcgra_vec.cuh"

namespace {

constexpr int kBatchedPasses = 8;    // B2: groups of P pixels a thread takes
constexpr int kLane = 128;           // B4: block_n is a positive multiple of this
// B1's largest radius: its (2r + 1)^2 + 1 tap-bank rows are indexed by the
// int32 tap_sel.
constexpr int kMaxFusedRadius = 23169;

// --- B1: fused-ingest kernel ------------------------------------------------

template <typename T, bool kWindow, bool kDeviceBanks>
int launch_fused(const void* frames, const int* ops, const int* sel, const int* out_sel,
                 const int* tap_sel, const void* consts, const int* radii, const int* widths,
                 int* records, void* rec_consts, void* vals, void* out, int N, int H, int W,
                 int L, int max_w, int K, int C, int radius, int threads, int slots_a,
                 int slots_b, int bank_blocks, cudaStream_t stream) {
  const int R = kWindow ? radius : 0;
  const Layout lay = smem_layout(sizeof(T), R, kWindow ? 1 : 0, slots_a, slots_b, threads, C, L,
                                 max_w, K, kDeviceBanks);
  if (lay.total > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vcgra_tile_kernel<T, false, kWindow, kDeviceBanks>;
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_pack<T>(N, ops, sel, out_sel, tap_sel, consts, nullptr, widths, radii, records,
                       rec_consts, 1, N, L, max_w, K, C, kWindow ? kWindowTaps : kGlobalTaps,
                       lay.cols, threads, false, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int tile_cols = kTileRows * Vec<T>::N;
  const dim3 grid = kDeviceBanks
                        ? dim3(bank_blocks)
                        : dim3((W + tile_cols - 1) / tile_cols, (H + kTileRows - 1) / kTileRows, N);
  kernel<<<grid, threads, lay.total, stream>>>(
      static_cast<const T*>(frames), records, static_cast<const T*>(rec_consts), nullptr,
      radii, static_cast<T*>(out), static_cast<Vec<T>*>(vals), 1, N, H, W, L, max_w, K, C, R,
      slots_a, slots_b, false);
  return static_cast<int>(cudaGetLastError());
}

// --- B2 and B4: pre-packed channels -----------------------------------------

// One 16-byte copy from device memory into shared memory that holds no
// register while in flight (cp.async, L2 only); cp_async_wait() waits for
// all of the thread's copies and makes them visible to it.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem_dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// grid (ceil(groups / (threads * passes)), N apps); block b of app n takes
// groups [b * threads * passes, ...), pass by pass, so that a warp's
// threads read neighbouring 16 bytes in every pass.  B2 is the instance
// with kPasses = kBatchedPasses; B4 the one with kPasses = 0, which takes
// the `passes` argument instead and, on aligned rows, copies every live
// channel of a group into its value column with cp.async, all in flight
// at once.  kDeviceBanks: a 1-D grid of resident blocks whose value banks
// are in `vals`, each walking the (b, n) blocks of the 2-D grid in turn
// and reading its app's record where the pack launch wrote it.
template <typename T, int kPasses, bool kDeviceBanks>
__global__ void __launch_bounds__(128)
vcgra_batched_kernel(const T* __restrict__ xs, const int* __restrict__ records,
                     T* __restrict__ out, Vec<T>* __restrict__ vals, int64_t B, int N, int L,
                     int max_w, int K, int C, int slots_a, int slots_b, bool aligned,
                     int passes) {
  using V = Vec<T>;
  constexpr int P = V::N;
  const int n_pass = kPasses > 0 ? kPasses : passes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const Layout lay =
      smem_layout(sizeof(T), 0, 0, slots_a, slots_b, threads, C, L, max_w, K, kDeviceBanks);
  const int n_rec = record_ints(C, L, max_w, K);
  int* const s_rec = reinterpret_cast<int*>(smem + lay.ints);
  V* col_a;  // stride: threads
  V* col_b;
  if constexpr (kDeviceBanks) {
    col_a = vals + static_cast<int64_t>(blockIdx.x) * (slots_a + slots_b) * threads + tid;
    col_b = col_a + static_cast<int64_t>(slots_a) * threads;
  } else {
    col_a = reinterpret_cast<V*>(smem + lay.vals_a) + tid;
    col_b = reinterpret_cast<V*>(smem + lay.vals_b) + tid;
    for (int i = tid; i < n_rec; i += threads)
      s_rec[i] = records[static_cast<int64_t>(blockIdx.y) * n_rec + i];
    __syncthreads();
  }
  const int64_t per_block = static_cast<int64_t>(n_pass) * threads;
  const int64_t blocks_x = kDeviceBanks ? (B + per_block * P - 1) / (per_block * P) : 1;
  const int64_t n_items = kDeviceBanks ? blocks_x * N : 1;
  for (int64_t item = kDeviceBanks ? blockIdx.x : 0; item < n_items;
       item += kDeviceBanks ? gridDim.x : 1) {
    const int n = kDeviceBanks ? static_cast<int>(item / blocks_x) : blockIdx.y;
    const int64_t bx = kDeviceBanks ? item % blocks_x : blockIdx.x;
    const Record rec = record_at(
        kDeviceBanks ? const_cast<int*>(records) + static_cast<int64_t>(n) * n_rec : s_rec, C,
        L, max_w, K);
    const int n_tap = rec.counts[0];
    const T* x = xs + static_cast<int64_t>(n) * C * B;
    T* o = out + static_cast<int64_t>(n) * K * B;
    const int64_t first = bx * per_block + tid;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int64_t p = (first + static_cast<int64_t>(pass) * threads) * P;
      if (p >= B) break;
      auto fetch = [&](int2 t) {
        const T* row = x + t.x * B + p;
        if (aligned) return *reinterpret_cast<const V*>(row);
        V v;
#pragma unroll
        for (int e = 0; e < P; ++e) v.v[e] = p + e < B ? row[e] : zero_value<T>();
        return v;
      };
      int taps = n_tap;
      if (kPasses == 0 && !kDeviceBanks && aligned) {
        for (int c = 0; c < n_tap; ++c) {
          const int2 t = rec.tap[c];
          cp_async16(col_a + t.y, x + t.x * B + p);
        }
        cp_async_wait();
        taps = 0;
      }
      const V* src = eval_group<T>(col_a, col_b, rec, nullptr, taps, 0, 0, L, max_w, fetch);
      store_outputs<T>(o + p, B, src, rec.out, K, aligned, B - p);
    }
  }
}

// B2 (kPasses = kBatchedPasses) and B4 (kPasses = 0, `passes` a block).
template <typename T, int kPasses, bool kDeviceBanks>
int launch_batched(const void* xs, const int* ops, const int* sel, const int* out_sel,
                   const int* widths, int* records, void* vals, void* out, int N, int64_t B,
                   int L, int max_w, int K, int C, int threads, int slots_a, int slots_b,
                   int passes, int bank_blocks, cudaStream_t stream) {
  auto kernel = vcgra_batched_kernel<T, kPasses, kDeviceBanks>;
  const Layout lay =
      smem_layout(sizeof(T), 0, 0, slots_a, slots_b, threads, C, L, max_w, K, kDeviceBanks);
  if (lay.total > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_pack<T>(N, ops, sel, out_sel, nullptr, nullptr, nullptr, widths, nullptr,
                       records, nullptr, 1, N, L, max_w, K, C, kChannelTaps, 0, threads, false,
                       stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int P = Vec<T>::N;
  const int64_t per_block = static_cast<int64_t>(threads) * passes * P;
  const bool aligned = B % P == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid = kDeviceBanks ? dim3(bank_blocks)
                                 : dim3(static_cast<unsigned>((B + per_block - 1) / per_block), N);
  kernel<<<grid, threads, lay.total, stream>>>(
      static_cast<const T*>(xs), records, static_cast<T*>(out), static_cast<Vec<T>*>(vals), B, N,
      L, max_w, K, C, slots_a, slots_b, aligned, passes);
  return static_cast<int>(cudaGetLastError());
}

// B4's passes: block_n pixels a block in passes of threads * P, at least
// one, and no more than N needs (a block_n past N takes N in one block).
template <typename T>
int conventional_passes(int threads, int64_t N, int64_t block_n) {
  const int64_t per_pass = static_cast<int64_t>(threads) * Vec<T>::N;
  const int64_t want = (block_n + per_pass - 1) / per_pass;
  const int64_t most = (N + per_pass - 1) / per_pass;
  return static_cast<int>(want < most ? want : most > 0 ? most : 1);
}

bool valid_vec_launch(int C, int threads, int slots_a, int slots_b, const void* vals,
                      int bank_blocks) {
  return slots_a >= C && slots_a >= 1 && slots_b >= 1 &&
         (threads == 32 || threads == 64 || threads == 128) &&
         (vals == nullptr || bank_blocks >= 1);
}

}  // namespace

// Limits: the largest radius of B1's shared-memory window, and of B1 at
// all.
extern "C" int vcgra_window_max_radius() { return kMaxWindowRadius; }
extern "C" int vcgra_fused_max_radius() { return kMaxFusedRadius; }

// Ints of one app's settings record (B1, B2, B4), and bytes of the pack
// launch's liveness bitmaps.
extern "C" int vcgra_record_ints(int C, int L, int max_w, int K) {
  return record_ints(C, L, max_w, K);
}
extern "C" int vcgra_pack_smem(int C, int max_w) { return pack_smem(C, max_w); }

// Bytes of dynamic shared memory one block takes (elem: the dtype's
// bytes; device_banks: the banks in device memory): B1 at `radius` (with
// its window up to kMaxWindowRadius, without past it), B2 and B4.
extern "C" int vcgra_fused_smem(int elem, int radius, int slots_a, int slots_b, int threads,
                                int C, int L, int max_w, int K, int device_banks) {
  const bool window = radius <= kMaxWindowRadius;
  return static_cast<int>(smem_layout(elem, window ? radius : 0, window ? 1 : 0, slots_a,
                                      slots_b, threads, C, L, max_w, K, device_banks != 0)
                              .total);
}
extern "C" int vcgra_batched_smem(int elem, int slots_a, int slots_b, int threads, int C, int L,
                                  int max_w, int K, int device_banks) {
  return static_cast<int>(
      smem_layout(elem, 0, 0, slots_a, slots_b, threads, C, L, max_w, K, device_banks != 0)
          .total);
}

// Static shared memory bytes of one B4 block for dtype code `dtype` (its
// value columns are dynamic shared memory), or -1.
extern "C" int vcgra_conventional_static_smem(int dtype) {
  auto bytes = [](auto kernel) {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess
               ? static_cast<int>(attr.sharedSizeBytes)
               : -1;
  };
  switch (dtype) {
    case 0: return bytes(vcgra_batched_kernel<int32_t, 0, false>);
    case 1: return bytes(vcgra_batched_kernel<int16_t, 0, false>);
    case 2: return bytes(vcgra_batched_kernel<float, 0, false>);
    case 3: return bytes(vcgra_batched_kernel<__nv_bfloat16, 0, false>);
    default: return -1;
  }
}

// Registers a thread takes in kernel `kernel` (0: B1 with its window, 1:
// B1 reading taps from device memory, 2: B2, 3: B4; 4-7: the same with
// their value banks in device memory) for dtype code `dtype`, or -1.
extern "C" int vcgra_kernel_regs(int kernel, int dtype) {
#define VCGRA_REGS(CODE, T)                                                            \
  case CODE:                                                                           \
    switch (kernel) {                                                                  \
      case 0: return kernel_regs(vcgra_tile_kernel<T, false, true, false>);            \
      case 1: return kernel_regs(vcgra_tile_kernel<T, false, false, false>);           \
      case 2: return kernel_regs(vcgra_batched_kernel<T, kBatchedPasses, false>);      \
      case 3: return kernel_regs(vcgra_batched_kernel<T, 0, false>);                   \
      case 4: return kernel_regs(vcgra_tile_kernel<T, false, true, true>);             \
      case 5: return kernel_regs(vcgra_tile_kernel<T, false, false, true>);            \
      case 6: return kernel_regs(vcgra_batched_kernel<T, kBatchedPasses, true>);       \
      case 7: return kernel_regs(vcgra_batched_kernel<T, 0, true>);                    \
      default: return -1;                                                              \
    }
  switch (dtype) {
    VCGRA_REGS(0, int32_t)
    VCGRA_REGS(1, int16_t)
    VCGRA_REGS(2, float)
    VCGRA_REGS(3, __nv_bfloat16)
    default: return -1;
  }
#undef VCGRA_REGS
}

// dtype codes: 0 int32, 1 int16, 2 float32, 3 bfloat16.  threads (32, 64 or
// 128) per block; slots_a / slots_b: the two value banks' slots
// (ops.value_slots).  A bad code, a radius past kMaxFusedRadius or a block
// over kMaxSmem returns cudaErrorInvalidValue without launching.  radii:
// int32 [1] on the device, the radius.  Scratch the caller allocates:
// records int32 [N, vcgra_record_ints(C, L, max_w, K)] and rec_consts [N,
// C] of the grid dtype, the settings records the first launch packs; with
// `vals` (not null) the value banks of bank_blocks resident blocks,
// bank_blocks * (slots_a + slots_b) * threads 16-byte vectors, and the
// kernel takes its device-bank instance.
extern "C" int vcgra_fused_batched(int dtype, const void* frames, const int* ops,
                                   const int* sel, const int* out_sel, const int* tap_sel,
                                   const void* consts, const int* radii, const int* widths,
                                   void* records, void* rec_consts, void* vals, void* out,
                                   int N, int H, int W, int L, int max_w, int K, int C,
                                   int radius, int threads, int slots_a, int slots_b,
                                   int bank_blocks, void* stream) {
  if (!valid_vec_launch(C, threads, slots_a, slots_b, vals, bank_blocks) || radius < 0 ||
      radius > kMaxFusedRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool window = radius <= kMaxWindowRadius, banks = vals != nullptr;
#define VCGRA_FUSED(CODE, T)                                                                 \
  case CODE: {                                                                               \
    auto launch = window ? (banks ? launch_fused<T, true, true> : launch_fused<T, true, false>) \
                         : (banks ? launch_fused<T, false, true>                             \
                                  : launch_fused<T, false, false>);                          \
    return launch(frames, ops, sel, out_sel, tap_sel, consts, radii, widths,                 \
                  static_cast<int*>(records), rec_consts, vals, out, N, H, W, L, max_w, K, C, \
                  radius, threads, slots_a, slots_b, bank_blocks, st);                       \
  }
  switch (dtype) {
    VCGRA_FUSED(0, int32_t)
    VCGRA_FUSED(1, int16_t)
    VCGRA_FUSED(2, float)
    VCGRA_FUSED(3, __nv_bfloat16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VCGRA_FUSED
}

// As vcgra_fused_batched, over pre-packed channels xs [N, C, B]; scratch:
// records int32 [N, vcgra_record_ints(C, L, max_w, K)] and, with `vals`,
// the device-memory value banks.
extern "C" int vcgra_batched(int dtype, const void* xs, const int* ops, const int* sel,
                             const int* out_sel, const int* widths, void* records, void* vals,
                             void* out, int N, int64_t B, int L, int max_w, int K, int C,
                             int threads, int slots_a, int slots_b, int bank_blocks,
                             void* stream) {
  if (!valid_vec_launch(C, threads, slots_a, slots_b, vals, bank_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool banks = vals != nullptr;
#define VCGRA_BATCHED(CODE, T)                                                               \
  case CODE:                                                                                 \
    return (banks ? launch_batched<T, kBatchedPasses, true>                                  \
                  : launch_batched<T, kBatchedPasses, false>)(                               \
        xs, ops, sel, out_sel, widths, static_cast<int*>(records), vals, out, N, B, L, max_w, \
        K, C, threads, slots_a, slots_b, kBatchedPasses, bank_blocks, st);
  switch (dtype) {
    VCGRA_BATCHED(0, int32_t)
    VCGRA_BATCHED(1, int16_t)
    VCGRA_BATCHED(2, float)
    VCGRA_BATCHED(3, __nv_bfloat16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VCGRA_BATCHED
}

// One app over channel-major x [C, N] -> out [K, N] (B4): as vcgra_batched
// with N = 1 app over B = N pixels; block_n pixels a block (a positive
// multiple of kLane, else cudaErrorInvalidValue without launching);
// scratch: records int32 [vcgra_record_ints(C, L, max_w, K)] and, with
// `vals`, the device-memory value banks.
extern "C" int vcgra_conventional(int dtype, const void* x, const int* ops, const int* sel,
                                  const int* out_sel, const int* widths, void* records,
                                  void* vals, void* out, int64_t N, int64_t block_n, int L,
                                  int max_w, int K, int C, int threads, int slots_a, int slots_b,
                                  int bank_blocks, void* stream) {
  if (block_n <= 0 || block_n % kLane != 0 ||
      !valid_vec_launch(C, threads, slots_a, slots_b, vals, bank_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool banks = vals != nullptr;
#define VCGRA_CONVENTIONAL(CODE, T)                                                          \
  case CODE:                                                                                 \
    return (banks ? launch_batched<T, 0, true> : launch_batched<T, 0, false>)(               \
        x, ops, sel, out_sel, widths, static_cast<int*>(records), vals, out, 1, N, L, max_w,  \
        K, C, threads, slots_a, slots_b, conventional_passes<T>(threads, N, block_n),        \
        bank_blocks, st);
  switch (dtype) {
    VCGRA_CONVENTIONAL(0, int32_t)
    VCGRA_CONVENTIONAL(1, int16_t)
    VCGRA_CONVENTIONAL(2, float)
    VCGRA_CONVENTIONAL(3, __nv_bfloat16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VCGRA_CONVENTIONAL
}
