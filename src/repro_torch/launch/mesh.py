"""Worker process groups of the sharded step, the port of
``repro/launch/mesh.py``.

The reference runs the sharded step as one SPMD program over a device mesh
whose ``data`` axis holds the LAQ workers.  The port runs one process per
worker: a rank of a ``torch.distributed`` group.  Worker m is rank m, and
it takes rows ``[m B / W, (m + 1) B / W)`` of a global batch of B rows, as
``P("data", None)`` shards them.  The reference's mesh constructors
(``make_production_mesh``, ``make_test_mesh``) build TPU meshes and have
no counterpart here.

Transports:

* ``nccl``: the collectives run on the card's tensors (one rank per card;
  NCCL refuses two ranks on one device).
* ``gloo`` with CPU tensors: the CPU tests' ranks.
* ``gloo`` with CUDA tensors: several ranks on one card.  Each payload is
  staged explicitly through pinned host memory on its way out and back
  (:attr:`WorkerGroup.transport` says so).  The kernels still run on the
  card: this is how the bytes travel, not a fallback of the computation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


class WorkerGroup(NamedTuple):
    """The LAQ workers of one sharded step, seen from one of them."""
    group: object           # the torch.distributed ProcessGroup
    size: int               # W, the number of workers
    rank: int               # this process's worker index m
    backend: str            # "gloo" | "nccl"

    def transport(self, device) -> str:
        """How a payload on ``device`` travels between the workers."""
        if self.backend == "gloo" and torch.device(device).type == "cuda":
            return "gloo, staged through pinned host memory"
        return self.backend

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_gather(self, t: torch.Tensor) -> list:
        """Every worker's ``t``, in worker order.  Under the staged
        transport the tensors lie in pinned host memory: consumers move
        each to the card as they take it (``x.to(device)``), so at most
        one of the W copies is on the card at a time."""
        if self._staged(t):
            t = _pinned_copy(t)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def permute(self, t: torch.Tensor) -> torch.Tensor:
        """The peer's ``t`` in a two-worker group (the reference's
        ``ppermute`` over the pairs (0, 1), (1, 0)); pinned host memory
        under the staged transport."""
        if self.size != 2:
            raise ValueError(f"permute pairs two workers, the group has "
                             f"{self.size}")
        if self._staged(t):
            t = _pinned_copy(t)
        peer = torch.empty_like(t)
        other = dist.get_global_rank(self.group, 1 - self.rank)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.contiguous(), other, self.group),
            dist.P2POp(dist.irecv, peer, other, self.group)])
        for r in reqs:
            r.wait()
        return peer


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def init_workers(backend: str, world_size: int, rank: int,
                 store) -> WorkerGroup:
    """Join the worker group as worker ``rank`` of ``world_size``, with
    rendezvous through ``store`` (a ``torch.distributed`` Store: a
    ``FileStore``, or a ``TCPStore`` on a port the caller chose)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dist.init_process_group(backend, store=store, world_size=world_size,
                            rank=rank)
    return WorkerGroup(dist.group.WORLD, world_size, rank, backend)


def n_workers_of(workers: WorkerGroup) -> int:
    return workers.size


def worker_index(workers: WorkerGroup) -> int:
    """This process's worker index m (its rank in the group)."""
    return workers.rank


def worker_batch(batch: dict, workers: WorkerGroup) -> dict:
    """This worker's rows of a global batch: ``[m B / W, (m + 1) B / W)``
    of every ``[B, ...]`` array."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % workers.size:
            raise ValueError(f"batch of {B} rows does not split over "
                             f"{workers.size} workers")
        per = B // workers.size
        out[k] = v[workers.rank * per:(workers.rank + 1) * per]
    return out
