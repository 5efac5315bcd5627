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
// tile kernel's chain instance, vcgra_tile_kernel<T, true, true, ...>:
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
//     The wrapper (ops.pipeline_launch) picks the most threads of 128 and
//     64 that fit the 232,448 bytes a block may take; past a 64-thread
//     block, the kDeviceBanks instance keeps the value banks in a
//     device-memory scratch of the resident blocks.
//   * Segments.  One launch holds a segment of the chain whose radii sum
//     to R <= kMaxWindowRadius (16); the wrapper (ops.chain_segments)
//     splits a longer chain greedily, and a stage whose own radius is
//     past 16 runs alone on the chain instance without a window
//     (vcgra_tile_kernel<T, true, false, ...>: taps from device memory).
//     Every segment but the last writes its masked forward, the same
//     value the trapezoid keeps between its stages, as the next segment's
//     frame [N, H, W] (`forward`); the pack launch then takes liveness
//     from the forwarded channel for the segment's last stage.  A chain of
//     R <= 16 is one segment, one launch.
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

template <typename T, bool kWindow, bool kDeviceBanks>
int launch_pipeline(const void* frames, const int* ops, const int* sel, const int* out_sel,
                    const int* tap_sel, const void* consts, const int* out_chs, const int* hw,
                    const int* widths, const int* radii, int* records, void* rec_consts,
                    void* vals, void* out, int S, int N, int H, int W, int L, int max_w, int K,
                    int C, int R, int threads, int slots_a, int slots_b, int bank_blocks,
                    bool forward, cudaStream_t stream) {
  const int Rw = kWindow ? R : 0;
  const Layout lay = smem_layout(sizeof(T), Rw, kWindow ? 2 : 0, slots_a, slots_b, threads, C,
                                 L, max_w, K, kDeviceBanks);
  if (lay.total > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vcgra_tile_kernel<T, true, kWindow, kDeviceBanks>;
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_pack<T>(S * N, ops, sel, out_sel, tap_sel, consts, out_chs, widths, radii,
                       records, rec_consts, S, N, L, max_w, K, C,
                       kWindow ? kWindowTaps : kGlobalTaps, lay.cols, threads, forward, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int tile_cols = kTileRows * Vec<T>::N;
  const dim3 grid = kDeviceBanks
                        ? dim3(bank_blocks)
                        : dim3((W + tile_cols - 1) / tile_cols, (H + kTileRows - 1) / kTileRows, N);
  kernel<<<grid, threads, lay.total, stream>>>(
      static_cast<const T*>(frames), records, static_cast<const T*>(rec_consts), hw, radii,
      static_cast<T*>(out), static_cast<Vec<T>*>(vals), S, N, H, W, L, max_w, K, C, Rw, slots_a,
      slots_b, forward);
  return static_cast<int>(cudaGetLastError());
}

// A segment: stages whose radii sum to R within the window, or one stage
// past it.
bool valid_launch(int S, int R, int C, int threads, int slots_a, int slots_b, const void* vals,
                  int bank_blocks) {
  return S >= 1 && R >= 0 && (R <= kMaxWindowRadius || S == 1) && slots_a >= C &&
         slots_a >= 1 && slots_b >= 1 && (threads == 32 || threads == 64 || threads == 128) &&
         (vals == nullptr || bank_blocks >= 1);
}

}  // namespace

extern "C" int vcgra_max_radius() { return kMaxWindowRadius; }

// Bytes of dynamic shared memory one block takes (elem: the dtype's bytes)
// for a segment of total radius R: two window buffers up to
// kMaxWindowRadius, none past it; device_banks: the banks in device memory.
extern "C" int vcgra_pipeline_smem(int elem, int R, int slots_a, int slots_b, int threads,
                                   int C, int L, int max_w, int K, int device_banks) {
  const bool window = R <= kMaxWindowRadius;
  return static_cast<int>(smem_layout(elem, window ? R : 0, window ? 2 : 0, slots_a, slots_b,
                                      threads, C, L, max_w, K, device_banks != 0)
                              .total);
}

// Ints of one (stage, app) settings record.
extern "C" int vcgra_pipeline_record_ints(int C, int L, int max_w, int K) {
  return record_ints(C, L, max_w, K);
}

// Registers a thread takes in kernel `kernel` (0: a segment with its
// window, 1: a lone stage reading taps from device memory; 2, 3: the same
// with their value banks in device memory) for dtype code `dtype`, or -1.
extern "C" int vcgra_pipeline_regs(int kernel, int dtype) {
#define VCGRA_REGS(CODE, T)                                                 \
  case CODE:                                                                \
    switch (kernel) {                                                       \
      case 0: return kernel_regs(vcgra_tile_kernel<T, true, true, false>);  \
      case 1: return kernel_regs(vcgra_tile_kernel<T, true, false, false>); \
      case 2: return kernel_regs(vcgra_tile_kernel<T, true, true, true>);   \
      case 3: return kernel_regs(vcgra_tile_kernel<T, true, false, true>);  \
      default: return -1;                                                   \
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

// One segment of a chain.  dtype codes: 0 int32, 1 int16, 2 float32, 3
// bfloat16.  threads (32, 64 or 128) per block; slots_a / slots_b: the
// two value banks' slots (bank A: the C channels and levels 1, 3, ...;
// bank B: levels 0, 2, ...).  R: the segment's sum of radii; past
// kMaxWindowRadius the segment is one stage (S = 1) without a window.  A
// bad code, an empty segment, R past the window over more than one stage
// or a block over kMaxSmem returns cudaErrorInvalidValue without
// launching.  radii: int32 [S] on the device; the settings carry a
// leading stage axis [S, N, ...].  forward (0/1): write the last stage's
// masked forward, out [N, H, W], instead of its K outputs, out [N, K,
// H*W].  Scratch the caller allocates: records int32 [S * N,
// vcgra_pipeline_record_ints(C, L, max_w, K)] and rec_consts [S * N, C]
// of the grid dtype, the settings records a first launch packs; with
// `vals` (not null) the value banks of bank_blocks resident blocks,
// bank_blocks * (slots_a + slots_b) * threads 16-byte vectors.
extern "C" int vcgra_pipeline_batched(int dtype, const void* frames, const int* ops,
                                      const int* sel, const int* out_sel, const int* tap_sel,
                                      const void* consts, const int* out_chs, const int* hw,
                                      const int* widths, const int* radii, void* records,
                                      void* rec_consts, void* vals, void* out, int S, int N,
                                      int H, int W, int L, int max_w, int K, int C, int R,
                                      int threads, int slots_a, int slots_b, int bank_blocks,
                                      int forward, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_launch(S, R, C, threads, slots_a, slots_b, vals, bank_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool window = R <= kMaxWindowRadius, banks = vals != nullptr;
#define VCGRA_PIPELINE(CODE, T)                                                              \
  case CODE: {                                                                               \
    auto launch = window ? (banks ? launch_pipeline<T, true, true>                           \
                                  : launch_pipeline<T, true, false>)                         \
                         : (banks ? launch_pipeline<T, false, true>                          \
                                  : launch_pipeline<T, false, false>);                       \
    return launch(frames, ops, sel, out_sel, tap_sel, consts, out_chs, hw, widths, radii,    \
                  static_cast<int*>(records), rec_consts, vals, out, S, N, H, W, L, max_w, K, \
                  C, R, threads, slots_a, slots_b, bank_blocks, forward != 0, st);           \
  }
  switch (dtype) {
    VCGRA_PIPELINE(0, int32_t)
    VCGRA_PIPELINE(1, int16_t)
    VCGRA_PIPELINE(2, float)
    VCGRA_PIPELINE(3, __nv_bfloat16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VCGRA_PIPELINE
}
