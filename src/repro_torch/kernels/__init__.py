"""Hand-written Hopper kernels of the port, one sub-package per kernel
(`ref.py` plain PyTorch, `kernel.py` build + bind + launch, `ops.py`
dispatch, `csrc/` CUDA C++ sources), plus `build`, the shared
nvcc-and-ctypes loader, and `counts`, the caller-owned launch counts of
the model path's kernels."""
