"""The process group of the GNN's partition axis.

Twin of repro/launch/mesh.py's `make_mesh((k,), ("parts",))`, for the one
axis the full-batch GNN shards over. The reference builds a `jax.sharding.Mesh`
over k devices of one controller; here each partition is a process of its
own, and `make_mesh` joins (or creates) the `torch.distributed` process
group those k processes share, from the usual environment:

    RANK, WORLD_SIZE        this process's rank and the group's size
    MASTER_ADDR, MASTER_PORT the rendezvous (`init_method="env://"`)
    LOCAL_RANK              the card of this rank on its machine

so `torchrun --nproc-per-node 4` on a machine with four cards starts it.
`launch/ranks.py` spawns the k processes itself and passes a file
rendezvous instead.

The backend is the caller's to choose; nothing switches it on its own:

    nccl  one card per rank (rank r on card LOCAL_RANK); raises when the
          mesh has more ranks than visible cards
    gloo  ranks on the CPU, or ranks that share a card: device tensors
          pass through host memory around each collective
          (core/collectives.py)

The reference's `make_production_mesh` (a (16, 16) or (2, 16, 16) TPU pod)
and its `TPU_V5E` constants have no twin: they describe TPU pods.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

AXIS = "parts"
BACKENDS = ("gloo", "nccl")
INIT_TIMEOUT = 300.0  # seconds a rendezvous or a collective may wait


@dataclasses.dataclass
class Mesh:
    """One rank's view of the partition axis: its rank, the group's size,
    the backend, the device its tensors live on, and what it has handed
    to `torch.distributed` (core/collectives.py counts it)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    # bytes handed to torch.distributed and calls, by collective kind
    sent: Counter = dataclasses.field(default_factory=Counter)
    calls: Counter = dataclasses.field(default_factory=Counter)
    # host seconds in the staging copies, and inside the collectives
    # (transport and the wait for peers)
    stage_seconds: float = 0.0
    collective_seconds: float = 0.0

    @property
    def staged(self) -> bool:
        """gloo with device tensors: buffers go through host memory."""
        return self.backend == "gloo" and self.device.type != "cpu"

    def reset_counters(self) -> None:
        self.sent.clear()
        self.calls.clear()
        self.stage_seconds = 0.0
        self.collective_seconds = 0.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              backend: str, device: Optional[str] = None,
              init_method: str = "env://") -> Mesh:
    """Join (or create) the process group of a one-axis mesh of k =
    shape[0] ranks and return this rank's `Mesh`. `device` is "cuda" (the
    default: rank r's card, r modulo the visible cards under gloo) or
    "cpu" (gloo only). INIT_TIMEOUT bounds the rendezvous and every
    collective: a rank whose peer died raises instead of waiting."""
    if len(shape) != 1 or len(axes) != 1:
        raise ValueError(f"the port's mesh has one axis (the GNN's "
                         f"partitions); got shape {shape}, axes {axes}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    k = int(shape[0])
    cards = torch.cuda.device_count()
    if backend == "nccl":
        if k > cards:
            raise RuntimeError(
                f"backend 'nccl' needs one card per rank: the mesh has {k} "
                f"ranks and {cards} card(s) are visible; ranks that share a "
                "card (or run on the CPU) take backend 'gloo'")
        if device not in (None, "cuda"):
            raise ValueError(f"backend 'nccl' runs on the card; got device "
                             f"{device!r}")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()!r}"
                               f", not {backend!r}")
    else:
        rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
        if rank is None or world is None:
            raise RuntimeError(
                "make_mesh joins a process group from RANK and WORLD_SIZE "
                "(and MASTER_ADDR / MASTER_PORT for env://), as torchrun "
                "sets them; launch/ranks.py spawns such ranks")
    if world != k:
        raise ValueError(f"the mesh has {k} ranks but the process group "
                         f"has {world}")
    kind = resolve_device(device or "cuda").type
    if kind == "cuda":
        local = _env_int("LOCAL_RANK")
        dev = torch.device("cuda", (rank if local is None else local) % cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT))
    return Mesh(rank=rank, size=world, backend=backend, device=dev)
