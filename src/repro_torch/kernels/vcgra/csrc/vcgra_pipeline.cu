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
// spends its instructions on PEs.  The design is vcgra_vec.cuh's (shared
// with B1 and B2): P = 16 / sizeof(T) pixels a thread in 16-byte value
// columns; settings decoded once per (stage, app) by a first launch
// (vcgra_pack_settings, one warp each) into a record of the live PEs and
// live channels only, which the main kernel copies to shared memory before
// the stage; one pe_vec call site with the next PE prefetched; taps at
// precomputed window offsets; no division or modulo per pixel.  B3 is the
// tile kernel's chain instance, vcgra_tile_kernel<T, true, true>:
//
//   * The trapezoid.  One block per (app, 32-row x 32P-column output
//     tile: 32 x 128 for 32-bit grids, 32 x 256 for 16-bit).  It loads the
//     (32 + 2R) x (32P + 2R) window of the frame into shared memory once,
//     R = sum of the stage radii; stage i computes the tile grown by the
//     radii after it, from the previous stage's region, into the second
//     (ping-pong) region buffer.  The halo costs ~8% more pixels than the
//     tile at R = 3.
//   * Masking, which makes the chain bitwise equal to the staged oracle:
//     after every non-final stage a forwarded value outside the app's
//     [0,h) x [0,w) is set to 0.  Forwarding follows the oracle
//     (interpreter.forward_stage_output): stage i forwards its OUTPUT
//     channel out_ch, i.e. the last level's slot out_sel[out_ch] -- not
//     slot out_ch as the Pallas body does.
//   * Dynamic shared memory (smem_layout): two region buffers of (32 + 2R)
//     x (32P + 2Rp + 2P) elements, (slots_a + slots_b) x threads x 16
//     bytes of value columns, and the stage's settings record.  The int32
//     depth-3 chain on pipe-shared (C 19, levels 11 7 5 4 3 2: 30 slots a
//     thread) takes 106 KB at 128 threads: two blocks (8 warps) an SM.
//     The wrapper (ops.pipeline_launch) picks the most threads of 128, 64,
//     32 that fit the 232,448 bytes a block may take; at the limits (R =
//     16, 64 + 64 slots) 64 threads take ~215 KB.  R > 16 or a value
//     vector wider than 64 is refused.
//   * PE semantics are vcgra_pe.cuh's, lane by lane: floor DIV with a
//     guarded divisor, wrapping int16, __f*_rn float ops under
//     --fmad=false, NaN-propagating MAX/MIN, bf16 rounded after every PE.
//     Radius-0 stages take a 1-tap bank.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or the error of the shared-memory
// attribute call).

#include "vcgra_vec.cuh"

namespace {

template <typename T>
int launch_pipeline(const void* frames, const int* ops, const int* sel, const int* out_sel,
                    const int* tap_sel, const void* consts, const int* out_chs, const int* hw,
                    const int* widths, const int* radii, int* records, void* rec_consts,
                    void* out, int S, int N, int H, int W, int L, int max_w, int K, int C,
                    int R, int threads, int slots_a, int slots_b, cudaStream_t stream) {
  const Layout lay = smem_layout(sizeof(T), R, 2, slots_a, slots_b, threads, C, L, max_w, K);
  if (lay.total > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(vcgra_tile_kernel<T, true, true>, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  vcgra_pack_settings<T><<<S * N, 32, 0, stream>>>(
      ops, sel, out_sel, tap_sel, static_cast<const T*>(consts), out_chs, widths, radii,
      records, static_cast<T*>(rec_consts), S, N, L, max_w, K, C, kWindowTaps, lay.cols,
      threads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int tile_cols = kTileRows * Vec<T>::N;
  const dim3 grid((W + tile_cols - 1) / tile_cols, (H + kTileRows - 1) / kTileRows, N);
  vcgra_tile_kernel<T, true, true><<<grid, threads, lay.total, stream>>>(
      static_cast<const T*>(frames), records, static_cast<const T*>(rec_consts), hw, radii,
      static_cast<T*>(out), S, N, H, W, L, max_w, K, C, R, slots_a, slots_b);
  return static_cast<int>(cudaGetLastError());
}

bool valid_launch(int S, int R, int C, int max_w, int threads, int slots_a, int slots_b) {
  return S >= 1 && R >= 0 && R <= kMaxWindowRadius && C <= kVecMaxVals &&
         max_w <= kVecMaxVals && slots_a >= C && slots_a >= 1 && slots_a <= kVecMaxVals &&
         slots_b >= 1 && slots_b <= kVecMaxVals &&
         (threads == 32 || threads == 64 || threads == 128);
}

}  // namespace

extern "C" int vcgra_max_vals() { return kVecMaxVals; }
extern "C" int vcgra_max_radius() { return kMaxWindowRadius; }

// Bytes of dynamic shared memory one block takes (elem: the dtype's bytes).
extern "C" int vcgra_pipeline_smem(int elem, int R, int slots_a, int slots_b, int threads,
                                   int C, int L, int max_w, int K) {
  return static_cast<int>(
      smem_layout(elem, R, 2, slots_a, slots_b, threads, C, L, max_w, K).total);
}

// Ints of one (stage, app) settings record.
extern "C" int vcgra_pipeline_record_ints(int C, int L, int max_w, int K) {
  return record_ints(C, L, max_w, K);
}

// Registers a thread of the kernel for dtype code `dtype` takes, or -1.
extern "C" int vcgra_pipeline_regs(int dtype) {
  switch (dtype) {
    case 0: return kernel_regs(vcgra_tile_kernel<int32_t, true, true>);
    case 1: return kernel_regs(vcgra_tile_kernel<int16_t, true, true>);
    case 2: return kernel_regs(vcgra_tile_kernel<float, true, true>);
    case 3: return kernel_regs(vcgra_tile_kernel<__nv_bfloat16, true, true>);
    default: return -1;
  }
}

// dtype codes: 0 int32, 1 int16, 2 float32, 3 bfloat16.  threads (32, 64
// or 128) per block; slots_a / slots_b: the two value banks' slots (bank
// A: the C channels and levels 1, 3, ...; bank B: levels 0, 2, ...).  A
// bad code, an empty chain, R > kMaxWindowRadius, a value vector wider
// than kVecMaxVals or a block over kMaxSmem returns cudaErrorInvalidValue without
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
