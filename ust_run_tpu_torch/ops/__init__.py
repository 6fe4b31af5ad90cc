"""Device-side data ops of the port and its hand-written CUDA kernels."""
