"""Carry the reference package's parameters into the port and back.

The port keeps the reference's parameter layout (nested dicts, stacked
``[L, ...]`` block tensors, the same leaf names), so conversion is a
per-leaf copy between numpy and torch.  numpy has no native bfloat16: a
bfloat16 leaf (``ml_dtypes``' dtype, as ``np.asarray`` of a JAX array
gives it) travels as float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .tree import tree_map


def _to_torch(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_numpy(tree, *, device="cuda"):
    """Nested dict of numpy arrays -> the port's parameter pytree."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_torch(a, dev), tree)


def params_to_numpy(params):
    """The port's parameter pytree -> nested dict of numpy arrays
    (bfloat16 leaves as float32)."""
    def to_np(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(to_np, params)
