"""Pytree checkpoints, port of ``repro/checkpoint/ckpt.py``: the leaves in
one npz under ``'/'``-joined key paths, plus a ``__step__`` entry.

The keys are the reference's: dict keys (sorted, as JAX flattens them),
NamedTuple field names and tuple indices, joined by ``'/'``.  bfloat16
leaves are stored as float32 under ``BF16::<key>``.  The file is written
to ``<path>.tmp`` and moved into place with ``os.replace``, so a crash
never leaves half a checkpoint.

The port keeps its worker axis as a Python list (``qhat``, the lazy, SVRG
and error-feedback pytrees, and the ``delay`` participation ring), where
the reference has a leading axis.  A list is stored stacked on a leading
axis under the list's own key: worker m's ``qhat`` leaf ``x`` is row m of
``1/qhat/x``, of shape ``[W, ...]``, as the reference stores it.  So a
carry saved by either package resumes in the other.  What still differs
in structure:

* the port's bookkeeping ints (``total_uploads``, ``step``) are stored as
  int32 0-d arrays, as the reference holds them, and load back as ints;
* an SVRG ``mu_anchor`` not yet set (before the first round) is stored as
  zeros, as the reference initializes it.

The running carry holds references to one iterate in several slots of its
:class:`~repro_torch.tree.SharedIterates` lists (``theta_last``,
``theta_anchor``, the ``delay`` ring); the file keeps a row per slot, as
the reference's stacked arrays do.  A load gives those rows back as one
tensor per distinct iterate, shared by every slot whose row holds the
same bits (across the three fields too), so a resumed carry holds no more
copies than the unbroken one.  Every other list (``qhat``, the EMAs, the
error memory) is updated in place and loads as one tensor per row.
"""
from __future__ import annotations

import hashlib
import os
from typing import Tuple

import numpy as np
import torch

from ..tree import SharedIterates

_BF16 = "BF16::"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``[(key, child)]`` of a container node in JAX's order, or None for
    a leaf (lists are handled by the callers)."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, tuple):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _join(path, key):
    return f"{path}/{key}" if path else key


def _fill_svrg(node):
    """An SVRG state whose ``mu_anchor`` entries are not set yet gets the
    matching ``theta_anchor`` entry in their place: its structure (for a
    load) or, through :func:`_zeros_like`, zeros (for a save)."""
    if (_is_namedtuple(node) and getattr(node, "_fields", None)
            == ("theta_anchor", "mu_anchor") and isinstance(node[1], list)
            and any(m is None for m in node[1])):
        return node._replace(mu_anchor=[
            _ZerosLike(t) if m is None else m
            for t, m in zip(node.theta_anchor, node.mu_anchor)])
    return node


class _ZerosLike:
    """Stands for a zero pytree shaped like ``tree`` (an unset SVRG mu)."""

    def __init__(self, tree):
        self.tree = tree


def _to_numpy(leaf):
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return leaf.detach().cpu().numpy() if leaf.dtype != torch.bfloat16 \
        else leaf.detach().to(torch.float32).cpu().numpy()


def _flatten(node, path, out: dict):
    """``out[key] = (numpy array, is_bf16)`` for every leaf under ``node``."""
    node = _fill_svrg(node)
    if node is None:
        return
    if isinstance(node, _ZerosLike):
        sub = {}
        _flatten(node.tree, path, sub)
        out.update({k: (np.zeros_like(a), bf) for k, (a, bf) in sub.items()})
        return
    if isinstance(node, list):
        per = []
        for elem in node:
            sub = {}
            _flatten(elem, path, sub)
            per.append(sub)
        keys = sorted(per[0]) if per else []
        if any(sorted(p) != keys for p in per):
            raise ValueError(f"{path}: the list's elements differ in "
                             f"structure; only per-worker lists stack")
        for k in keys:
            out[k] = (np.stack([p[k][0] for p in per]), per[0][k][1])
        return
    kids = _children(node)
    if kids is None:
        bf = isinstance(node, torch.Tensor) and node.dtype == torch.bfloat16
        out[path] = (_to_numpy(node), bf)
        return
    for k, c in kids:
        _flatten(c, _join(path, k), out)


def save_checkpoint(path: str, tree, step: int) -> None:
    """Write ``tree``'s leaves and ``step`` to ``path`` (npz), atomically."""
    leaves = {}
    _flatten(tree, "", leaves)
    flat = {(_BF16 + k if bf else k): a for k, (a, bf) in leaves.items()}
    flat["__step__"] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str, tree_template) -> Tuple[object, int]:
    """Restore into the structure, dtypes and devices of ``tree_template``.

    A key of the template missing from the file, or an entry of the file
    the template does not consume, raises ``KeyError`` naming every such
    key (the common cause: a ``CommState`` whose optional fields -- lazy,
    svrg, error, defense -- were configured otherwise than in the run that
    saved; the watchdog's escalation migrates such carries field by field
    instead).  A shape mismatch raises ``ValueError``."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    if "__step__" not in data:
        raise KeyError(f"{path}: not a repro checkpoint (no __step__ entry)")
    step = int(data.pop("__step__"))
    used, missing = set(), []
    pool = {}   # the shared iterates' rows: (bits, dtype, device) -> tensor

    def lookup(key):
        for k in (_BF16 + key, key):
            if k in data:
                used.add(k)
                return data[k]
        missing.append(key)
        return None

    def shared_tensor(arr, node):
        """The tensor of a shared iterate's row: one per distinct row
        bits, dtype and device."""
        row = np.ascontiguousarray(arr)
        key = (hashlib.blake2b(row.view(np.uint8), digest_size=16).digest(),
               row.dtype.str, row.shape, node.dtype, str(node.device))
        for other, t in pool.get(key, ()):
            if np.array_equal(other.view(np.uint8), row.view(np.uint8)):
                return t
        t = torch.from_numpy(row.copy()).to(dtype=node.dtype,
                                            device=node.device)
        pool.setdefault(key, []).append((row, t))
        return t

    def restore(node, kp, index, shared):
        """``node`` restored from the file; ``kp`` is its key path,
        ``index`` selects the rows of the enclosing lists' stacked arrays
        and ``shared`` says that one of them is a
        :class:`~repro_torch.tree.SharedIterates`."""
        node = _fill_svrg(node)
        if isinstance(node, _ZerosLike):
            node = node.tree
        if node is None:
            return None
        if isinstance(node, list):
            sh = shared or isinstance(node, SharedIterates)
            return type(node)(restore(e, kp, index + (m,), sh)
                              for m, e in enumerate(node))
        kids = _children(node)
        if kids is None:
            arr = lookup(kp)
            if arr is None:
                return node
            arr = arr[index] if index else arr
            shape = () if isinstance(node, (bool, int, float)) \
                else tuple(node.shape)
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"{path}: shape mismatch at '{kp}': checkpoint "
                    f"{tuple(arr.shape)} vs template {shape}")
            if isinstance(node, (bool, int, float)):
                return type(node)(arr)
            if shared:
                return shared_tensor(arr, node)
            return torch.from_numpy(np.array(arr)).to(dtype=node.dtype,
                                                      device=node.device)
        vals = [restore(c, _join(kp, k), index, shared) for k, c in kids]
        if isinstance(node, dict):
            return dict(zip(sorted(node), vals))
        if _is_namedtuple(node):
            return type(node)(*vals)
        return tuple(vals)

    restored = restore(tree_template, "", (), False)
    extra = sorted(set(data) - used)
    if missing or extra:
        raise KeyError(
            f"{path}: template leaves missing from the checkpoint: "
            f"{sorted(set(missing))}; checkpoint entries not consumed by the "
            f"template: {extra} -- the saved run used a different "
            f"configuration")
    return restored, step
