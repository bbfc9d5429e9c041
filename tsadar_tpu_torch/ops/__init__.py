"""Hand-written CUDA kernels of the port and their build (imported lazily, built at first use)."""
