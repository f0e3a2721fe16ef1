"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``ops`` dispatches: a CUDA tensor goes to the kernel, a CPU tensor
to the plain version.  Kernels are compiled at first use (``build``), never
at import, so this package imports on a machine without ``nvcc``."""
