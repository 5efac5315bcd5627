// Host shim of the specialized VCGRA kernel (B5): NVRTC compile, module load
// and launch of the per-application kernels that
// repro_torch/kernels/vcgra/specialized.py generates.
//
// Replaces the Pallas TPU kernel src/repro/kernels/vcgra/vcgra_kernel.py:
// vcgra_specialized (body _specialized_body), whose settings are trace-time
// constants: one XLA/Mosaic compile per application.  Here the same cut is a
// CUDA source per (grid, config, dtype, bake_consts) -- straight-line code,
// one PE per live slot with its opcode a literal, every VC mux folded into a
// named register -- compiled at Pixie.load() by NVRTC for sm_90a with
// --fmad=false.  The compile + load is the paper's micro-reconfiguration.
//
// What bounds a generated kernel on the H100: memory bytes.  It reads each
// live input row once and writes K output rows; the live PEs are a few dozen
// scalar ops per pixel, far below the card's scalar rate at 3.35 TB/s.  The
// design therefore keeps every value in registers (no shared memory, no value
// vector) and reads only the live rows, coalesced: neighbouring threads read
// neighbouring pixels of one channel row.
//
// The module is loaded through libcuda's cu* API into the device's primary context
// (the one PyTorch's runtime uses), so the kernel launches on PyTorch's
// streams.  The shim links libnvrtc and libcuda; it allocates nothing on the
// device and never synchronizes.
//
// C interface (bound with ctypes).  vcgra_spec_compile returns 0 ok, 1 when
// NVRTC refused the source (the log holds its messages), 2 for another NVRTC
// error, 3 for a failed cu* call (the log names the call);
// vcgra_spec_launch returns 0 ok, 3 for bad arguments or context, 1000 + the
// CUresult of a refused launch.  vcgra_spec_cubin hands the module's CUBIN
// back (for nvdisasm), vcgra_spec_attribute one cuFuncGetAttribute value of
// its kernel (registers a thread, static shared memory, ...).

#include <cuda.h>
#include <nvrtc.h>

#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Module {
  CUcontext ctx;
  CUdevice dev;
  CUmodule mod;
  CUfunction fn;
  std::vector<char> cubin;
};

void put_log(char* log, size_t loglen, const char* text) {
  if (log == nullptr || loglen == 0) return;
  std::snprintf(log, loglen, "%s", text);
}

int cu_error(CUresult rc, const char* call, char* log, size_t loglen) {
  const char* name = nullptr;
  cuGetErrorName(rc, &name);
  char buf[256];
  std::snprintf(buf, sizeof(buf), "%s failed: %s (%d)", call, name ? name : "?",
                static_cast<int>(rc));
  put_log(log, loglen, buf);
  return 3;
}

}  // namespace

// Compile `src` (which may #include the header `header_name`, given as
// `header_src`) with `opts`, load the CUBIN into device `device`'s primary
// context and look up `kernel_name`.  On success *handle owns the module.
extern "C" int vcgra_spec_compile(const char* src, const char* header_src,
                                  const char* header_name, const char** opts, int nopts,
                                  const char* kernel_name, int device, void** handle,
                                  char* log, size_t loglen) {
  *handle = nullptr;
  nvrtcProgram prog;
  nvrtcResult nr = nvrtcCreateProgram(&prog, src, "vcgra_specialized.cu", 1, &header_src,
                                      &header_name);
  if (nr != NVRTC_SUCCESS) {
    put_log(log, loglen, nvrtcGetErrorString(nr));
    return 2;
  }
  nr = nvrtcCompileProgram(prog, nopts, opts);
  if (nr != NVRTC_SUCCESS) {
    size_t n = 0;
    nvrtcGetProgramLogSize(prog, &n);
    std::vector<char> text(n + 1, '\0');
    nvrtcGetProgramLog(prog, text.data());
    put_log(log, loglen, text.data());
    nvrtcDestroyProgram(&prog);
    return nr == NVRTC_ERROR_COMPILATION ? 1 : 2;
  }
  size_t cubin_size = 0;
  nr = nvrtcGetCUBINSize(prog, &cubin_size);
  std::vector<char> cubin(cubin_size);
  if (nr == NVRTC_SUCCESS) nr = nvrtcGetCUBIN(prog, cubin.data());
  nvrtcDestroyProgram(&prog);
  if (nr != NVRTC_SUCCESS) {
    put_log(log, loglen, nvrtcGetErrorString(nr));
    return 2;
  }

  Module m{};
  CUresult rc = cuInit(0);
  if (rc != CUDA_SUCCESS) return cu_error(rc, "cuInit", log, loglen);
  rc = cuDeviceGet(&m.dev, device);
  if (rc != CUDA_SUCCESS) return cu_error(rc, "cuDeviceGet", log, loglen);
  rc = cuDevicePrimaryCtxRetain(&m.ctx, m.dev);
  if (rc != CUDA_SUCCESS) return cu_error(rc, "cuDevicePrimaryCtxRetain", log, loglen);
  const char* call = "cuCtxSetCurrent";
  rc = cuCtxSetCurrent(m.ctx);
  if (rc == CUDA_SUCCESS) {
    call = "cuModuleLoadData";
    rc = cuModuleLoadData(&m.mod, cubin.data());
  }
  if (rc != CUDA_SUCCESS) {
    cuDevicePrimaryCtxRelease(m.dev);
    return cu_error(rc, call, log, loglen);
  }
  rc = cuModuleGetFunction(&m.fn, m.mod, kernel_name);
  if (rc != CUDA_SUCCESS) {
    cuModuleUnload(m.mod);
    cuDevicePrimaryCtxRelease(m.dev);
    return cu_error(rc, "cuModuleGetFunction", log, loglen);
  }
  m.cubin = std::move(cubin);
  *handle = new Module(std::move(m));
  put_log(log, loglen, "");
  return 0;
}

// Launch the module's kernel over n pixels: x [C, ldx] channel rows, y [K, n]
// output rows, block_n pixels per block of `threads` threads, on `stream`.
extern "C" int vcgra_spec_launch(void* handle, const void* x, void* y, long long n,
                                 long long ldx, long long block_n, int threads,
                                 void* stream) {
  const Module* m = static_cast<const Module*>(handle);
  if (m == nullptr || n <= 0 || block_n <= 0 || threads <= 0) return 3;
  CUresult rc = cuCtxSetCurrent(m->ctx);
  if (rc != CUDA_SUCCESS) return 3;
  const long long blocks = (n + block_n - 1) / block_n;
  if (blocks > 0x7fffffffLL) return 3;  // the launch's grid.x limit
  void* args[] = {&x, &y, &n, &ldx, &block_n};
  rc = cuLaunchKernel(m->fn, static_cast<unsigned>(blocks), 1, 1,
                      static_cast<unsigned>(threads), 1, 1, 0,
                      static_cast<CUstream>(stream), args, nullptr);
  return rc == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(rc);
}

// The CUBIN the module was loaded from: returns its size, and copies it into
// `buf` when `len` holds it (call with len 0 for the size); -1 for no module.
extern "C" int vcgra_spec_cubin(void* handle, void* buf, int len) {
  const Module* m = static_cast<const Module*>(handle);
  if (m == nullptr) return -1;
  const int size = static_cast<int>(m->cubin.size());
  if (buf != nullptr && len >= size) std::memcpy(buf, m->cubin.data(), m->cubin.size());
  return size;
}

// cuFuncGetAttribute(`attribute`) of the module's kernel (a CUfunction_attribute:
// 4 registers a thread, 1 static shared bytes, ...), or -1.
extern "C" int vcgra_spec_attribute(void* handle, int attribute) {
  const Module* m = static_cast<const Module*>(handle);
  if (m == nullptr) return -1;
  int value = -1;
  const CUresult rc =
      cuFuncGetAttribute(&value, static_cast<CUfunction_attribute>(attribute), m->fn);
  return rc == CUDA_SUCCESS ? value : -1;
}

extern "C" int vcgra_spec_free(void* handle) {
  Module* m = static_cast<Module*>(handle);
  if (m == nullptr) return 0;
  cuCtxSetCurrent(m->ctx);
  const CUresult rc = cuModuleUnload(m->mod);
  cuDevicePrimaryCtxRelease(m->dev);
  delete m;
  return rc == CUDA_SUCCESS ? 0 : 3;
}
