// Hand-written Hopper (sm_90a) kernel for chained VCGRA requests.
//
// Replaces the Pallas TPU megakernel vcgra_pipeline_batched of the JAX
// reference package (src/repro/kernels/vcgra/vcgra_kernel.py, body
// _pipeline_batched_body): N tenants, each running a depth-S chain of
// applications on its own raw frame, in ONE launch.  Stage i's forwarded
// output feeds stage i+1's tap bank; the last stage writes K outputs.
//
// What bounds it on the H100: memory bytes.  Run as S separate launches,
// every stage would read a frame and write an intermediate through HBM; the
// PE work per pixel (sum of pes_per_level scalar ops per stage) is far below
// the card's scalar rate at 3.35 TB/s.  So the chain keeps its
// intermediates in shared memory: each frame pixel crosses HBM once per
// chain (plus the tile halo), each output once.
//
// Design (right before fast):
//   * grid (W tiles, H tiles, N apps): one block per (app, 32 x 32 output
//     tile).  It loads a (32 + 2R) x (32 + 2R) window of the frame into
//     shared memory once, R = sum of the stage radii; taps outside
//     [0,H) x [0,W) read 0.
//   * The trapezoid: stage i computes a (32 + 2 reach_i)^2 region, reach_i
//     = sum of the radii after i, from the previous stage's region (the
//     window for stage 0).  Its threads stride over the region in chunks of
//     the block; each pixel runs the L PE levels in its shared-memory value
//     column (vals[slot][thread], as B1 does: a mux select is one
//     conflict-free shared read), then the value goes to the second
//     (ping-pong) region buffer, and __syncthreads.  The halo costs
//     recomputation, ~13% more pixels than the tile for R = 3.
//   * Masking, which makes the chain bitwise equal to the staged oracle:
//     after every non-final stage a forwarded value whose global position
//     lies outside the app's [0,h) x [0,w) (from hw) is set to 0, halo
//     pixels outside the canvas included (h <= H, w <= W).  The last stage
//     is not masked; the caller slices.
//   * Forwarding follows the oracle (interpreter.forward_stage_output):
//     stage i forwards its OUTPUT channel out_ch, i.e. the last level's
//     slot out_sel[out_ch] -- not slot out_ch as the Pallas body does.
//   * Before each stage the block stages that stage's settings rows of its
//     app (ops, sel, out_sel, tap_sel, const, out_ch) in shared memory.
//   * Dynamic shared memory: two (32 + 2R)^2 region buffers, 2 x V x 128
//     value columns (V = max(C, widest level)), consts and settings.  For
//     the int32 depth-3 chain on the pipe-shared grid that is 31 KB; at
//     the limits (R = 16, V = 64) ~98 KB, above 48 KB only through
//     cudaFuncSetAttribute.  R > 16 or V > 64 is refused by the wrapper.
//   * PE semantics are B1's (vcgra_pe.cuh); radius-0 stages take a 1-tap
//     bank.  64-bit index math for N*K*H*W.
// wgmma, TMA and persistent blocks are left for later.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing and returns cudaGetLastError() (or the error of the shared-memory
// attribute call).

#include "vcgra_pe.cuh"

namespace {

constexpr int kTile = 32;            // output tile side (rows = cols)
constexpr int kThreads = 128;        // threads per block
constexpr int kMaxVals = 64;         // widest value vector: max(C, pes per level)
constexpr int kMaxTotalRadius = 16;  // largest sum of stage radii

struct Layout {
  // Byte offsets into dynamic shared memory.
  size_t buf1, vals, consts, ints, total;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// buf0 | buf1 | vals[2][V][kThreads] | consts[C] | ints: ops, sel, out_sel,
// tap_sel, widths, radii, out_ch.
__host__ __device__ inline Layout smem_layout(size_t elem, int R, int V, int C, int L,
                                              int max_w, int K, int S) {
  const size_t win = static_cast<size_t>(kTile + 2 * R);
  Layout l;
  l.buf1 = align16(win * win * elem);
  l.vals = l.buf1 + align16(win * win * elem);
  l.consts = l.vals + align16(2 * static_cast<size_t>(V) * kThreads * elem);
  l.ints = l.consts + align16(static_cast<size_t>(C) * elem);
  l.total = l.ints + sizeof(int) * (3 * static_cast<size_t>(L) * max_w + K + C + L + S + 1);
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
vcgra_pipeline_batched_kernel(const T* __restrict__ frames, const int* __restrict__ ops,
                              const int* __restrict__ sel, const int* __restrict__ out_sel,
                              const int* __restrict__ tap_sel, const T* __restrict__ consts,
                              const int* __restrict__ out_chs, const int* __restrict__ hw,
                              const int* __restrict__ widths, const int* __restrict__ radii,
                              T* __restrict__ out, int S, int N, int H, int W, int L,
                              int max_w, int K, int C, int V, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = smem_layout(sizeof(T), R, V, C, L, max_w, K, S);
  T* bufs[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem + lay.buf1)};
  T* vals = reinterpret_cast<T*>(smem + lay.vals);
  T* s_consts = reinterpret_cast<T*>(smem + lay.consts);
  const int n_ops = L * max_w;
  int* s_ops = reinterpret_cast<int*>(smem + lay.ints);
  int* s_sel = s_ops + n_ops;
  int* s_out = s_sel + 2 * n_ops;
  int* s_tap = s_out + K;
  int* s_w = s_tap + C;
  int* s_r = s_w + L;
  int* s_oc = s_r + S;

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int64_t hw_px = static_cast<int64_t>(H) * W;
  const int h = hw[2 * n], w = hw[2 * n + 1];

  for (int i = tid; i < L; i += kThreads) s_w[i] = widths[i];
  for (int i = tid; i < S; i += kThreads) s_r[i] = radii[i];
  // The frame window, zero outside [0,H) x [0,W).
  const int win = kTile + 2 * R;
  const T* frame = frames + static_cast<int64_t>(n) * hw_px;
  for (int q = tid; q < win * win; q += kThreads) {
    const int gy = ty0 - R + q / win, gx = tx0 - R + q % win;
    bufs[0][q] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? frame[static_cast<int64_t>(gy) * W + gx] : zero_value<T>();
  }

  int cur_buf = 0, in_w = win, reach_in = R;
  for (int s = 0; s < S; ++s) {
    __syncthreads();  // the previous stage is done with settings and buffers
    const int64_t app = static_cast<int64_t>(s) * N + n;
    for (int i = tid; i < n_ops; i += kThreads) s_ops[i] = ops[app * n_ops + i];
    for (int i = tid; i < 2 * n_ops; i += kThreads) s_sel[i] = sel[app * 2 * n_ops + i];
    for (int i = tid; i < K; i += kThreads) s_out[i] = out_sel[app * K + i];
    for (int i = tid; i < C; i += kThreads) {
      s_tap[i] = tap_sel[app * C + i];
      s_consts[i] = consts[app * C + i];
    }
    if (tid == 0) *s_oc = out_chs[app];
    __syncthreads();

    const int r = s_r[s];
    const int side = 2 * r + 1, zero_row = side * side;
    const int reach = reach_in - r;
    const int rw = kTile + 2 * reach;
    const bool last = s == S - 1;
    const T* in = bufs[cur_buf];
    T* nxt = bufs[1 - cur_buf];
    const int fwd_slot = last ? 0 : s_out[*s_oc];
    for (int base = 0; base < rw * rw; base += kThreads) {
      const int q = base + tid;
      const bool active = q < rw * rw;
      const int qy = active ? q / rw : 0, qx = active ? q % rw : 0;
      T* col = vals + tid;  // this thread's value column, stride kThreads
      for (int c = 0; c < C; ++c) {
        const int t = s_tap[c];
        T v = zero_value<T>();
        if (t == zero_row) {
          v = s_consts[c];
        } else if (t >= 0 && t < zero_row) {
          v = in[(qy + t / side) * in_w + qx + t % side];
        }
        col[c * kThreads] = v;
      }
      int cur = 0;
      for (int lvl = 0; lvl < L; ++lvl) {
        const int* lops = s_ops + lvl * max_w;
        const int* lsel = s_sel + 2 * lvl * max_w;
        const T* src = col + cur * V * kThreads;
        T* dst = col + (1 - cur) * V * kThreads;
        for (int slot = 0; slot < s_w[lvl]; ++slot)
          dst[slot * kThreads] = pe(lops[slot], src[lsel[2 * slot] * kThreads],
                                    src[lsel[2 * slot + 1] * kThreads]);
        cur = 1 - cur;
      }
      if (!active) continue;
      const T* res = col + cur * V * kThreads;
      const int gy = ty0 - reach + qy, gx = tx0 - reach + qx;
      if (last) {
        if (gy < H && gx < W) {
          const int64_t p = static_cast<int64_t>(gy) * W + gx;
          for (int k = 0; k < K; ++k)
            out[(static_cast<int64_t>(n) * K + k) * hw_px + p] = res[s_out[k] * kThreads];
        }
      } else {
        const bool keep = gy >= 0 && gy < h && gx >= 0 && gx < w;
        nxt[q] = keep ? res[fwd_slot * kThreads] : zero_value<T>();
      }
    }
    cur_buf = 1 - cur_buf;
    in_w = rw;
    reach_in = reach;
  }
}

template <typename T>
int launch_pipeline(const void* frames, const int* ops, const int* sel, const int* out_sel,
                    const int* tap_sel, const void* consts, const int* out_chs, const int* hw,
                    const int* widths, const int* radii, void* out, int S, int N, int H, int W,
                    int L, int max_w, int K, int C, int V, int R, cudaStream_t stream) {
  const size_t smem = smem_layout(sizeof(T), R, V, C, L, max_w, K, S).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vcgra_pipeline_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  vcgra_pipeline_batched_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(frames), ops, sel, out_sel, tap_sel, static_cast<const T*>(consts),
      out_chs, hw, widths, radii, static_cast<T*>(out), S, N, H, W, L, max_w, K, C, V, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vcgra_max_vals() { return kMaxVals; }
extern "C" int vcgra_max_radius() { return kMaxTotalRadius; }

// dtype codes: 0 int32, 1 int16, 2 float32, 3 bfloat16.  A bad code, an
// empty chain, R > kMaxTotalRadius or a value vector wider than kMaxVals
// returns cudaErrorInvalidValue without launching.  radii: int32 [S] on
// the device; the settings carry a leading stage axis [S, N, ...].
extern "C" int vcgra_pipeline_batched(int dtype, const void* frames, const int* ops,
                                      const int* sel, const int* out_sel, const int* tap_sel,
                                      const void* consts, const int* out_chs, const int* hw,
                                      const int* widths, const int* radii, void* out, int S,
                                      int N, int H, int W, int L, int max_w, int K, int C,
                                      int R, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = C > max_w ? C : max_w;
  if (S < 1 || R < 0 || R > kMaxTotalRadius || V > kMaxVals)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_pipeline<int32_t>(frames, ops, sel, out_sel, tap_sel, consts, out_chs,
                                            hw, widths, radii, out, S, N, H, W, L, max_w, K, C,
                                            V, R, st);
    case 1: return launch_pipeline<int16_t>(frames, ops, sel, out_sel, tap_sel, consts, out_chs,
                                            hw, widths, radii, out, S, N, H, W, L, max_w, K, C,
                                            V, R, st);
    case 2: return launch_pipeline<float>(frames, ops, sel, out_sel, tap_sel, consts, out_chs,
                                          hw, widths, radii, out, S, N, H, W, L, max_w, K, C, V,
                                          R, st);
    case 3: return launch_pipeline<__nv_bfloat16>(frames, ops, sel, out_sel, tap_sel, consts,
                                                  out_chs, hw, widths, radii, out, S, N, H, W, L,
                                                  max_w, K, C, V, R, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
