// Hand-written Hopper (sm_90a) kernel for the fused 3x3 stencil (B6).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stencil/stencil_kernel.py:
// stencil_fused (body _stencil_body): a fixed 3x3 convolution of a
// zero-padded [H, W] frame or, with two filters, |k0*img| + |k1*img| (the
// Sobel magnitude), written in the image dtype.
//
// Semantics, bit for bit the TPU kernel's: each term is tap * float(c) with
// the zero coefficients skipped, summed in row-major tap order from the
// first term (no zero start, no FMA: --fmad=false and __f*_rn).  Int32
// frames and float32 frames accumulate in float32 (an int32 tap converts
// with round-to-nearest) and the result is cast to the image dtype (float
// -> int32 truncates); bf16 frames accumulate in bf16, rounded after every
// multiply and add.
//
// What bounds it on the H100: memory bytes -- one read of the frame and one
// write of the result; the arithmetic is ~25 scalar ops per pixel.  The TPU
// kernel reads three row-shifted copies of the padded frame so its VMEM
// blocks see the row halo; here a block stages its (block_h + 2) x 34
// window once in shared memory (zeros outside the frame), so each frame
// value is read from device memory about once and no padded copy exists.
// The coefficients are compile-time constants: each library filter is a
// template instantiation, and the zero taps vanish at compile time.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue without a
// launch for an unknown dtype, filter or tile height).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileW = 32;      // output columns per block (one warp wide)
constexpr int kRowsPerPass = 8;  // thread rows per block
constexpr int kMaxBlockH = 128;  // output rows per block, at most

template <int K0, int K1, int K2, int K3, int K4, int K5, int K6, int K7, int K8>
struct Filter {
  __device__ static constexpr int at(int t) {
    return t == 0 ? K0 : t == 1 ? K1 : t == 2 ? K2 : t == 3 ? K3 : t == 4 ? K4
         : t == 5 ? K5 : t == 6 ? K6 : t == 7 ? K7 : K8;
  }
};

// The library filters (core/applications.py), ids as in stencil/ops.py.
using SobelX = Filter<-1, 0, 1, -2, 0, 2, -1, 0, 1>;
using SobelY = Filter<-1, -2, -1, 0, 0, 0, 1, 2, 1>;
using Gauss3 = Filter<1, 2, 1, 2, 4, 2, 1, 2, 1>;
using Sharpen = Filter<0, -1, 0, -1, 5, -1, 0, -1, 0>;
using Laplace = Filter<0, 1, 0, 1, -4, 1, 0, 1, 0>;
using Box3 = Filter<1, 1, 1, 1, 1, 1, 1, 1, 1>;
struct NoFilter {};

// Accumulation per image dtype.
template <typename T> struct Math;

template <> struct Math<int32_t> {
  using Acc = float;
  __device__ static int32_t zero() { return 0; }
  __device__ static float term(int32_t tap, float c) { return __fmul_rn(__int2float_rn(tap), c); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float abs(float a) { return fabsf(a); }
  __device__ static int32_t out(float a) { return __float2int_rz(a); }
};

template <> struct Math<float> {
  using Acc = float;
  __device__ static float zero() { return 0.0f; }
  __device__ static float term(float tap, float c) { return __fmul_rn(tap, c); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float abs(float a) { return fabsf(a); }
  __device__ static float out(float a) { return a; }
};

template <> struct Math<__nv_bfloat16> {
  using Acc = __nv_bfloat16;
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.0f); }
  __device__ static __nv_bfloat16 term(__nv_bfloat16 tap, float c) {
    return __float2bfloat16_rn(__fmul_rn(__bfloat162float(tap), c));
  }
  __device__ static __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  __device__ static __nv_bfloat16 abs(__nv_bfloat16 a) {
    return __float2bfloat16_rn(fabsf(__bfloat162float(a)));
  }
  __device__ static __nv_bfloat16 out(__nv_bfloat16 a) { return a; }
};

// One filter over the 3x3 window whose top-left is win[0] (row stride
// kTileW + 2): the terms of the nonzero coefficients, summed in tap order.
template <typename T, typename F>
__device__ __forceinline__ typename Math<T>::Acc convolve(const T* win) {
  constexpr int kStride = kTileW + 2;
  typename Math<T>::Acc acc{};
  bool first = true;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (F::at(t) == 0) continue;
    const auto term =
        Math<T>::term(win[(t / 3) * kStride + t % 3], static_cast<float>(F::at(t)));
    acc = first ? term : Math<T>::add(acc, term);
    first = false;
  }
  return acc;
}

template <typename T, typename F0, typename F1>
__global__ void __launch_bounds__(kTileW * kRowsPerPass)
stencil_kernel(const T* __restrict__ img, T* __restrict__ out, int H, int W, int block_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  constexpr int kStride = kTileW + 2;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * block_h;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int n_win = (block_h + 2) * kStride;
  for (int i = tid; i < n_win; i += kTileW * kRowsPerPass) {
    const int gy = y0 + i / kStride - 1;
    const int gx = x0 + i % kStride - 1;
    win[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? img[static_cast<int64_t>(gy) * W + gx] : Math<T>::zero();
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int r = threadIdx.y; r < block_h && y0 + r < H; r += kRowsPerPass) {
    const T* w = win + r * kStride + threadIdx.x;
    typename Math<T>::Acc res = convolve<T, F0>(w);
    if constexpr (!std::is_same<F1, NoFilter>::value)
      res = Math<T>::add(Math<T>::abs(res), Math<T>::abs(convolve<T, F1>(w)));
    out[static_cast<int64_t>(y0 + r) * W + x] = Math<T>::out(res);
  }
}

template <typename T, typename F0, typename F1>
int launch(const void* img, void* out, int H, int W, int block_h, cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + block_h - 1) / block_h);
  const dim3 block(kTileW, kRowsPerPass);
  const size_t smem = sizeof(T) * (block_h + 2) * (kTileW + 2);
  stencil_kernel<T, F0, F1><<<grid, block, smem, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), H, W, block_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_filters(int f0, int f1, const void* img, void* out, int H, int W, int block_h,
                   cudaStream_t st) {
  if (f1 < 0) {
    switch (f0) {
      case 0: return launch<T, SobelX, NoFilter>(img, out, H, W, block_h, st);
      case 1: return launch<T, SobelY, NoFilter>(img, out, H, W, block_h, st);
      case 2: return launch<T, Gauss3, NoFilter>(img, out, H, W, block_h, st);
      case 3: return launch<T, Sharpen, NoFilter>(img, out, H, W, block_h, st);
      case 4: return launch<T, Laplace, NoFilter>(img, out, H, W, block_h, st);
      case 5: return launch<T, Box3, NoFilter>(img, out, H, W, block_h, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (f0 == 0 && f1 == 1) return launch<T, SobelX, SobelY>(img, out, H, W, block_h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int stencil_max_block_h() { return kMaxBlockH; }

// dtype codes as the VCGRA kernels': 0 int32, 2 float32, 3 bfloat16.  f0, f1:
// library filter ids (f1 = -1 for one filter; the pair (0, 1) is the Sobel
// magnitude).
extern "C" int stencil_fused(int dtype, int f0, int f1, const void* img, void* out, int H,
                             int W, int block_h, void* stream) {
  if (block_h < 1 || block_h > kMaxBlockH || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_filters<int32_t>(f0, f1, img, out, H, W, block_h, st);
    case 2: return launch_filters<float>(f0, f1, img, out, H, W, block_h, st);
    case 3: return launch_filters<__nv_bfloat16>(f0, f1, img, out, H, W, block_h, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
