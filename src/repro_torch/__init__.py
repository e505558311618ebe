"""repro_torch: the PyTorch/CUDA port of `repro`, the queue-model
performance predictor for intermediate storage from "Predicting
Intermediate Storage Performance for Workflow Applications" (Costa et
al., 2013).

Same sub-package layout as `repro` (`core/`, `core/sweep/`,
`kernels/sweep_scan/`, `obs/`) so every module sits where its
counterpart does. The package imports `torch` and `numpy` only; entry
points that touch tensors take an explicit ``device`` argument that
defaults to ``"cuda"`` and raise when no card is present (pass
``device="cpu"`` to run the plain PyTorch paths on the host).
"""
__version__ = "1.0.0"
