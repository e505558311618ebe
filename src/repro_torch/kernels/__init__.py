"""Hand-written Hopper kernels of the port, one sub-package per kernel
(`ref.py` plain PyTorch, `kernel.py` build + bind + launch, `ops.py`
dispatch and launch counter, `csrc/` CUDA C++ sources), plus `build`,
the shared nvcc-and-ctypes loader."""
