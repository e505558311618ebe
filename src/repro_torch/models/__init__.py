"""Model substrate in PyTorch for the serving and training paths: dense
GQA, top-k MoE, Mamba2/SSD, hybrid (zamba2) and the audio/vlm stubs, the
counterpart of `repro.models`."""
from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                     ArchConfig, ShapeConfig)
from .layers import count_params, init_params
from .model import (DecodeState, cast_params, decode_step, forward, init,
                    init_decode_state, loss_fn, model_defs, n_params,
                    padded_vocab)

__all__ = ["ALL_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K", "TRAIN_4K",
           "ArchConfig", "ShapeConfig", "count_params", "init_params",
           "DecodeState", "cast_params", "decode_step", "forward", "init",
           "init_decode_state", "loss_fn", "model_defs", "n_params",
           "padded_vocab"]
