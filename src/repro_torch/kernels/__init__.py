"""Hand-written CUDA kernels (`csrc/`), their ctypes wrappers and plain
PyTorch versions, and the QNet-level routing in `ops`."""
