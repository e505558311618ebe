"""Weights and decode state carried across from the reference package.

The port keeps the reference's parameter layout (nested dicts, layers
stacked on a leading axis, the hybrid's ``[groups, every, ...]``
stacking), so a parameter tree converts leaf for leaf. Whoever holds
reference-side arrays (the parity tests, a migration script) turns them
into NumPy arrays on their side (``jax.tree.map(np.asarray, params)``)
and hands them over here; both packages then compute the same function.
NumPy arrays of dtype ``bfloat16`` (as JAX exports them) are taken bit
for bit.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..env import DeviceLike, resolve_device
from .model import DecodeState
from .ssm import SSMState
from .transformer import KVCache


def tensor_from_numpy(a, device: DeviceLike = "cuda") -> torch.Tensor:
    """One array as a tensor on ``device``, in the array's dtype."""
    a = np.array(a, order="C")             # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_numpy(tree: Mapping[str, Any], device: DeviceLike = "cuda"):
    """The reference's parameter tree (nested dicts of arrays) as the
    port's parameters: same keys, same stacking, tensors on ``device``."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def decode_state_from_numpy(kv: Optional[Mapping[str, Any]],
                            ssm: Optional[Mapping[str, Any]], pos,
                            device: DeviceLike = "cuda") -> DecodeState:
    """A `DecodeState` from the reference's: ``kv`` holds ``k``, ``v``
    (stacked caches) and ``length``; ``ssm`` holds ``h`` and ``conv``
    (stacked states); either may be None, as the family has it."""
    new_kv = new_ssm = None
    if kv is not None:
        new_kv = KVCache(tensor_from_numpy(kv["k"], device),
                         tensor_from_numpy(kv["v"], device),
                         int(np.asarray(kv["length"])))
    if ssm is not None:
        new_ssm = SSMState(tensor_from_numpy(ssm["h"], device),
                           tensor_from_numpy(ssm["conv"], device))
    return DecodeState(kv=new_kv, ssm=new_ssm, pos=int(np.asarray(pos)))
