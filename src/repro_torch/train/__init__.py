"""Step functions of the port: training and serving."""
from .step import TrainState, make_prefill_step, make_serve_step, make_train_step

__all__ = ["TrainState", "make_prefill_step", "make_serve_step",
           "make_train_step"]
