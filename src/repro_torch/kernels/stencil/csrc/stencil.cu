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
// blocks see the row halo.  Here each thread takes a strip of V adjacent
// output columns (16 bytes: V = 4 for int32 and float32, 8 for bf16) down
// the block's block_h output rows, kChunk (8) rows at a time: a chunk's
// kChunk + 2 frame rows are loaded together, all in flight at once, and
// its rows then compute from a 3-row window in registers.  Each frame row
// is read by one chunk, or two at a chunk edge: block_h + 2 rows for
// block_h <= 8 outputs.  Loads and stores are one 16 bytes a strip row
// where the rows are 16-byte aligned (W a multiple of V, both pointers
// aligned), V scalar ones otherwise, masked at the ragged edge.  The
// columns beside the strip come from the neighbouring lanes by warp
// shuffles; the warp's two edge lanes load them (zeros outside the frame).
// No shared memory, no barrier, no division or modulo per element.  The
// coefficients are compile-time constants: each library filter is a
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

constexpr int kThreads = 128;     // threads a block, each a strip of V columns
constexpr int kMaxBlockH = 128;   // output rows per block, at most
constexpr int kChunk = 8;         // output rows whose frame rows load together
constexpr unsigned kFullMask = 0xffffffffu;

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

// Accumulation per image dtype, two neighbouring columns at a time (Acc
// holds both).  Taps enter as float (in(): exact for bf16,
// round-to-nearest for int32), converted once per loaded value.  bf16
// rounds both columns' values with one conversion instruction, each
// exactly as a lone __float2bfloat16_rn would.
template <typename T> struct Math;

struct Float32Math {
  using Acc = float2;
  __device__ static float2 term(float a, float b, float c) {
    return make_float2(__fmul_rn(a, c), __fmul_rn(b, c));
  }
  __device__ static float2 add(float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  __device__ static float2 abs(float2 a) { return make_float2(fabsf(a.x), fabsf(a.y)); }
};

template <> struct Math<int32_t> : Float32Math {
  __device__ static int32_t zero() { return 0; }
  __device__ static float in(int32_t v) { return __int2float_rn(v); }
  __device__ static void out(float2 a, int32_t* o) {
    o[0] = __float2int_rz(a.x);
    o[1] = __float2int_rz(a.y);
  }
};

template <> struct Math<float> : Float32Math {
  __device__ static float zero() { return 0.0f; }
  __device__ static float in(float v) { return v; }
  __device__ static void out(float2 a, float* o) {
    o[0] = a.x;
    o[1] = a.y;
  }
};

template <> struct Math<__nv_bfloat16> {
  using Acc = __nv_bfloat162;
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.0f); }
  __device__ static float in(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static Acc term(float a, float b, float c) {
    return __floats2bfloat162_rn(__fmul_rn(a, c), __fmul_rn(b, c));
  }
  __device__ static Acc add(Acc a, Acc b) {
    return __floats2bfloat162_rn(__fadd_rn(__low2float(a), __low2float(b)),
                                 __fadd_rn(__high2float(a), __high2float(b)));
  }
  __device__ static Acc abs(Acc a) {
    return __floats2bfloat162_rn(fabsf(__low2float(a)), fabsf(__high2float(a)));
  }
  __device__ static void out(Acc a, __nv_bfloat16* o) {
    o[0] = __low2bfloat16(a);
    o[1] = __high2bfloat16(a);
  }
};

// V pixels of one image dtype: 16 bytes, one load or store.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
  T v[N];
};

// One frame row of a thread's strip as loaded: its V columns and, for a
// warp's first lane the column left of the strip, for its last lane the
// one right of it (0 for the other lanes); zeros outside the frame.
template <typename T>
struct Raw {
  Vec<T> v;
  T edge;
};

template <typename T>
__device__ __forceinline__ Raw<T> load_row(const T* __restrict__ img, int y, int H, int W,
                                           int x0, int lane, bool aligned, bool wanted) {
  constexpr int V = Vec<T>::N;
  Raw<T> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.v.v[e] = Math<T>::zero();
  r.edge = Math<T>::zero();
  if (!wanted || y < 0 || y >= H) return r;
  const T* row = img + static_cast<int64_t>(y) * W;
  if (aligned) {
    if (x0 < W) r.v = *reinterpret_cast<const Vec<T>*>(row + x0);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (x0 + e < W) r.v.v[e] = row[x0 + e];
  }
  const int ex = lane == 0 ? x0 - 1 : x0 + V;
  if ((lane == 0 || lane == 31) && ex >= 0 && ex < W) r.edge = row[ex];
  return r;
}

// A loaded row as the window row w[0..V+1] of the strip's V columns and
// the one on each side, as float: the sides from the neighbouring lanes
// (every lane of the warp takes part), or the edge lane's own load.
template <typename T>
__device__ __forceinline__ void window_row(const Raw<T>& r, int lane, float (&w)[Vec<T>::N + 2]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int e = 0; e < V; ++e) w[e + 1] = Math<T>::in(r.v.v[e]);
  const float edge = Math<T>::in(r.edge);
  const float left = __shfl_up_sync(kFullMask, w[V], 1);
  const float right = __shfl_down_sync(kFullMask, w[1], 1);
  w[0] = lane == 0 ? edge : left;
  w[V + 1] = lane == 31 ? edge : right;
}

// One filter at strip columns j and j + 1 of the 3-row window: the terms
// of the nonzero coefficients, summed in row-major tap order from the
// first.
template <typename T, typename F, int W2>
__device__ __forceinline__ typename Math<T>::Acc convolve(const float (&top)[W2],
                                                          const float (&mid)[W2],
                                                          const float (&bot)[W2], int j) {
  typename Math<T>::Acc acc{};
  bool first = true;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (F::at(t) == 0) continue;
    const int k = j + t % 3;
    const float a = t < 3 ? top[k] : t < 6 ? mid[k] : bot[k];
    const float b = t < 3 ? top[k + 1] : t < 6 ? mid[k + 1] : bot[k + 1];
    const auto term = Math<T>::term(a, b, static_cast<float>(F::at(t)));
    acc = first ? term : Math<T>::add(acc, term);
    first = false;
  }
  return acc;
}

// grid (ceil(ceil(W / V) / kThreads), ceil(H / block_h)): block (bx, by)
// takes output rows [by * block_h, ...) of the strips bx * kThreads + tid.
// Every lane runs every row (the shuffles need the whole warp); a strip
// past W loads zeros and stores nothing.
template <typename T, typename F0, typename F1>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const T* __restrict__ img, T* __restrict__ out, int H, int W, int block_h,
               bool aligned) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int x0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int y0 = blockIdx.y * block_h;
  const int rows = min(block_h, H - y0);
  // The tile's output rows kChunk at a time: the chunk's kChunk + 2 frame
  // rows are all in flight before its first row computes.
  T* orow = out + static_cast<int64_t>(y0) * W + x0;
  for (int c = 0; c < rows; c += kChunk) {
    Raw<T> raw[kChunk + 2];  // frame rows y0 + c - 1 ...
#pragma unroll
    for (int i = 0; i < kChunk + 2; ++i)
      raw[i] = load_row(img, y0 + c - 1 + i, H, W, x0, lane, aligned, c + i <= rows + 1);
    float top[V + 2], mid[V + 2], bot[V + 2];
    window_row(raw[0], lane, top);
    window_row(raw[1], lane, mid);
#pragma unroll
    for (int i = 0; i < kChunk; ++i, orow += W) {
      if (c + i >= rows) break;
      window_row(raw[i + 2], lane, bot);
      Vec<T> res;
#pragma unroll
      for (int j = 0; j < V; j += 2) {
        typename Math<T>::Acc acc = convolve<T, F0>(top, mid, bot, j);
        if constexpr (!std::is_same<F1, NoFilter>::value)
          acc = Math<T>::add(Math<T>::abs(acc), Math<T>::abs(convolve<T, F1>(top, mid, bot, j)));
        Math<T>::out(acc, res.v + j);
      }
      if (aligned) {
        if (x0 < W) *reinterpret_cast<Vec<T>*>(orow) = res;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (x0 + j < W) orow[j] = res.v[j];
      }
#pragma unroll
      for (int e = 0; e < V + 2; ++e) {
        top[e] = mid[e];
        mid[e] = bot[e];
      }
    }
  }
}

template <typename T, typename F0, typename F1>
int launch(const void* img, void* out, int H, int W, int block_h, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int strips = (W + V - 1) / V;
  const dim3 grid((strips + kThreads - 1) / kThreads, (H + block_h - 1) / block_h);
  const bool aligned = W % V == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  stencil_kernel<T, F0, F1><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), H, W, block_h, aligned);
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
