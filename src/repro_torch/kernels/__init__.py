"""Hand-written Hopper kernels of the PyTorch/CUDA port:

  vcgra/    the paper's PE-grid executor: B1/B2/B4 (settings as runtime
            data), B3 (chains) and B5 (one kernel generated per app,
            NVRTC-compiled at load)
  stencil/  the fused 3x3 stencil, B6
  flash_attention/  GQA flash decode attention, B7 (the LM serving path)

Each package: ``csrc/*.cu`` (built by ``build.py``), ``ops.py`` (wrappers
with launch counters) and ``ref.py`` (plain PyTorch versions).
"""
