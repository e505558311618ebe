"""Sharding rules and activation constraints of the port, on
`torch.distributed.tensor` (the counterpart of `repro.parallel`)."""
from .sharding import (batch_axes, constrain_activations, constrain_batch_dim,
                       constrain_decode_kv, constrain_logits, data_specs,
                       decode_state_specs, logical_rules, param_specs,
                       to_shardings)

__all__ = ["batch_axes", "constrain_activations", "constrain_batch_dim",
           "constrain_decode_kv", "constrain_logits", "data_specs",
           "decode_state_specs", "logical_rules", "param_specs",
           "to_shardings"]
