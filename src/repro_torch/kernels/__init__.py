"""Hand-written Hopper kernels of the PyTorch/CUDA port."""
