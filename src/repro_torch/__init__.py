"""Pixie VCGRA overlay in PyTorch, with hand-written CUDA kernels for Hopper.

The port of the JAX reference package ``repro``: same tool flow (DFG ->
place -> route -> settings), same plan/fleet/serving layers, layout
mirrored module by module (``repro_torch/<sub>/<mod>.py`` is the twin of
``repro/<sub>/<mod>.py``).  It imports neither JAX nor the reference.
"""
