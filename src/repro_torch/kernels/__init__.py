"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the dispatchers (`ops`) that route between them by device. Nothing is
compiled or loaded at import: a kernel is built at its first CUDA call."""
