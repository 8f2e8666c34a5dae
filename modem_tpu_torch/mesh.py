"""The 1-D device mesh over a ``torch.distributed`` process group, and its
one collective.

Stands in for ``jax.sharding.Mesh``: one process a rank, one device a
rank, the backend the caller's (NCCL between cards, gloo on the CPU).
Nothing falls back: an NCCL group on the CPU or a missing card raises.
Both ``sync`` (the sharded scan) and ``parallel`` (the sharded decodes)
build on it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import ClassVar

import torch
import torch.distributed as dist

AXIS = "dp"
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh over a process group (for ``jax.sharding.Mesh``):
    this process's rank in ``group`` of ``size`` ranks, its device, and
    the group's backend.  Hashable by its fields, the group by identity."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: ClassVar[str] = AXIS


def resolve(device) -> torch.device:
    """``device`` with a CUDA index made explicit (the current device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of an initialised process group (default: the default
    group) on ``device``, by default ``cuda:{local rank % cards}``.  Raises
    RuntimeError when ``torch.distributed`` is not initialised or no card
    is there for the default, ValueError for an NCCL group on the CPU or a
    backend other than NCCL and gloo."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group before make_mesh")
    group = dist.group.WORLD if group is None else group
    backend = str(dist.get_backend(group))
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the mesh takes {BACKENDS}")
    rank = dist.get_rank(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the rank: pass "
                               "device='cpu' to run it on the host")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group gathers on the card: its ranks "
                         f"need a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, rank, dist.get_world_size(group), device, backend)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes on every rank) concatenated along
    the first axis in rank order, on ``t``'s device.  NCCL gathers on the
    card; gloo is a host transport, so the rows go to the host and back."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.contiguous()
    if mesh.backend == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts).to(t.device)
    return out.bool() if t.dtype == torch.bool else out
