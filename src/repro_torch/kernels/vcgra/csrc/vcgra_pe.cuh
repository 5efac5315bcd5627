// PE semantics of the VCGRA overlay, shared by the Hopper kernels
// (vcgra.cu: B1/B2/B4, vcgra_pipeline.cu: B3, and every per-app B5 kernel
// that kernels/vcgra/specialized.py generates and NVRTC compiles).
//
// Bit for bit the JAX reference's core/ops.py: floor division with a
// guarded divisor (and INT_MIN / -1 == INT_MIN as XLA defines it), wrapping
// integer arithmetic, int16 results cast back after every PE, IEEE float
// ops with no FMA contraction (built with --fmad=false and written with
// __f*_rn), NaN-propagating MAX/MIN, bf16 rounded after every PE, and 0 for
// NONE, MAC and any unknown opcode.

#pragma once

#ifdef __CUDACC_RTC__
// NVRTC has no system headers: the fixed-width types from built-ins.
typedef int int32_t;
typedef short int16_t;
typedef unsigned int uint32_t;
typedef long long int64_t;
#define INT32_MIN (-2147483647 - 1)
#else
#include <cuda_runtime.h>
#include <stdint.h>
#endif
#include <cuda_bf16.h>

namespace {

enum Op : int {
  NONE = 0, ADD = 1, SUB = 2, MUL = 3, DIV = 4, GT = 5, EQ = 6, BUF = 7,
  MAX = 8, MIN = 9, ABS = 10,
};

// --- PE semantics, one specialisation per grid dtype ---------------------

__device__ __forceinline__ int32_t pe(int op, int32_t a, int32_t b) {
  const uint32_t ua = static_cast<uint32_t>(a), ub = static_cast<uint32_t>(b);
  switch (op) {
    case ADD: return static_cast<int32_t>(ua + ub);
    case SUB: return static_cast<int32_t>(ua - ub);
    case MUL: return static_cast<int32_t>(ua * ub);
    case DIV: {
      if (b == 0) return 0;
      if (a == INT32_MIN && b == -1) return INT32_MIN;
      int32_t q = a / b;
      if ((a % b) != 0 && ((a < 0) != (b < 0))) q -= 1;
      return q;
    }
    case GT: return a > b ? 1 : 0;
    case EQ: return a == b ? 1 : 0;
    case BUF: return a;
    case MAX: return a > b ? a : b;
    case MIN: return a < b ? a : b;
    case ABS: return a < 0 ? static_cast<int32_t>(0u - ua) : a;
    default: return 0;
  }
}

__device__ __forceinline__ int16_t pe(int op, int16_t a16, int16_t b16) {
  // C++ promotes to int; every result is cast back, so int16 wraps.
  const int a = a16, b = b16;
  switch (op) {
    case ADD: return static_cast<int16_t>(a + b);
    case SUB: return static_cast<int16_t>(a - b);
    case MUL: return static_cast<int16_t>(a * b);
    case DIV: {
      if (b == 0) return 0;
      int q = a / b;
      if ((a % b) != 0 && ((a < 0) != (b < 0))) q -= 1;
      return static_cast<int16_t>(q);
    }
    case GT: return a > b ? 1 : 0;
    case EQ: return a == b ? 1 : 0;
    case BUF: return a16;
    case MAX: return a > b ? a16 : b16;
    case MIN: return a < b ? a16 : b16;
    case ABS: return static_cast<int16_t>(a < 0 ? -a : a);
    default: return 0;
  }
}

__device__ __forceinline__ float pe(int op, float a, float b) {
  switch (op) {
    case ADD: return __fadd_rn(a, b);
    case SUB: return __fsub_rn(a, b);
    case MUL: return __fmul_rn(a, b);
    case DIV: return b == 0.0f ? 0.0f : __fdiv_rn(a, b);
    case GT: return a > b ? 1.0f : 0.0f;
    case EQ: return a == b ? 1.0f : 0.0f;
    case BUF: return a;
    case MAX:
      if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
      return a > b ? a : b;
    case MIN:
      if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
      return a < b ? a : b;
    case ABS: return fabsf(a);
    default: return 0.0f;
  }
}

__device__ __forceinline__ __nv_bfloat16 pe(int op, __nv_bfloat16 a, __nv_bfloat16 b) {
  // Each PE computes in float and rounds once to bf16.
  return __float2bfloat16_rn(pe(op, __bfloat162float(a), __bfloat162float(b)));
}

template <typename T> __device__ __forceinline__ T zero_value() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

}  // namespace
