"""Collectives between the ranks of a mesh (launch/mesh.py), with autograd.

The twins of the `lax` collectives the reference's per-device code calls
under `shard_map` (repro/gnn/sync.py, repro/core/wire.py), each a
`torch.autograd.Function` over `torch.distributed`:

  all_to_all(x, mesh)   x [k, ...]: out[j] is what rank j sent in its slot
                        for this rank (`lax.all_to_all(split_axis=0,
                        concat_axis=0)`); adjoint: the reverse all-to-all,
                        which is the same exchange
  psum(x, mesh)         all-reduce sum (`lax.psum`); adjoint: the psum of
                        the cotangent
  pmax(x, mesh)         all-reduce max (`lax.pmax`), forward only (GAT
                        takes its softmax shift under no_grad, the
                        reference's stop_gradient)
  all_gather(x, mesh)   [k, *x.shape], rank j's x at j (`lax.all_gather`);
                        adjoint: each rank's slot summed over the ranks
  ring_shift(x, mesh)   rank j's x goes to rank j-1 (the reference ring's
                        `lax.ppermute` pairs (j, j-1)); adjoint: the
                        inverse shift. One `batch_isend_irecv` a call: no
                        blocking send before a receive
  pmean_tree(tree, mesh) the mean over the ranks of a float32 tensor tree
                        (the gradients), in one all-reduce

Under gloo with device tensors (`Mesh.staged`), every buffer is copied to
host memory, handed to gloo, and copied back, so no path depends on which
collectives gloo accepts for CUDA tensors; under nccl and on the CPU the
tensors are handed as they are. bf16 buffers travel as their bytes.

Every call adds the bytes it hands to `torch.distributed` to
`mesh.sent[kind]` and one to `mesh.calls[kind]`, the kinds named as the
reference's compiled collectives are ("all-to-all", "all-reduce",
"all-gather", "collective-permute"), and its host seconds to two clocks:

  mesh.stage_seconds       the copies to and from host memory (staged
                           calls; a staged call first waits for the
                           device work it depends on, outside both clocks)
  mesh.collective_seconds  inside the torch.distributed call: the
                           transport, and the wait for peers that reach
                           the collective later (under nccl: the enqueue)

A rank's collective seconds hold the wait for its slowest peer, so the
least of them over the ranks is the nearest to the transport alone.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.optim.adam import leaves


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(mesh, kind: str, x: torch.Tensor) -> None:
    mesh.sent[kind] += _nbytes(x)
    mesh.calls[kind] += 1
    if mesh.staged:
        torch.cuda.current_stream(mesh.device).synchronize()


@contextlib.contextmanager
def _clock(mesh, field: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        setattr(mesh, field, getattr(mesh, field) + time.perf_counter() - t0)


def _stage(mesh, x: torch.Tensor, *, reduce: bool = False) -> torch.Tensor:
    """The buffer handed to torch.distributed: on the host when staged,
    contiguous. A reduce gets a fresh copy (it writes its buffer in place,
    never the caller's tensor); a move gets bf16 as its bytes."""
    with _clock(mesh, "stage_seconds"):
        if mesh.staged:
            x = x.cpu()
        elif reduce:
            x = x.clone()
        x = x.contiguous()
    if reduce or x.dtype != torch.bfloat16:
        return x
    return x.view(torch.uint8)


def _unstage(mesh, buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if buf.dtype != dtype:
        buf = buf.view(torch.bfloat16)
    if not mesh.staged:
        return buf
    with _clock(mesh, "stage_seconds"):
        return buf.to(mesh.device)


def _all_to_all(mesh, x: torch.Tensor) -> torch.Tensor:
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all splits dim 0 over {mesh.size} ranks; "
                         f"got shape {tuple(x.shape)}")
    _count(mesh, "all-to-all", x)
    buf = _stage(mesh, x)
    out = torch.empty_like(buf)
    with _clock(mesh, "collective_seconds"):
        dist.all_to_all_single(out, buf)
    return _unstage(mesh, out, x.dtype)


def _all_reduce(mesh, x: torch.Tensor, op) -> torch.Tensor:
    _count(mesh, "all-reduce", x)
    buf = _stage(mesh, x, reduce=True)
    with _clock(mesh, "collective_seconds"):
        dist.all_reduce(buf, op=op)
    return _unstage(mesh, buf, x.dtype)


def _all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    _count(mesh, "all-gather", x)
    buf = _stage(mesh, x)
    outs = [torch.empty_like(buf) for _ in range(mesh.size)]
    with _clock(mesh, "collective_seconds"):
        dist.all_gather(outs, buf)
    return _unstage(mesh, torch.stack(outs), x.dtype)


def _shift(mesh, x: torch.Tensor, offset: int) -> torch.Tensor:
    """Send x to rank + offset, receive from rank - offset (mod k)."""
    k = mesh.size
    if k == 1:
        return x.clone()
    _count(mesh, "collective-permute", x)
    buf = _stage(mesh, x)
    out = torch.empty_like(buf)
    with _clock(mesh, "collective_seconds"):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, (mesh.rank + offset) % k),
            dist.P2POp(dist.irecv, out, (mesh.rank - offset) % k)])
        for req in reqs:
            req.wait()
    return _unstage(mesh, out, x.dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.mesh, g), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(mesh, x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, dist.ReduceOp.SUM), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(mesh, x)

    @staticmethod
    def backward(ctx, g):
        # rank i's slot of every rank's cotangent, summed
        return _all_to_all(ctx.mesh, g).sum(0), None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _shift(mesh, x, -1)

    @staticmethod
    def backward(ctx, g):
        return _shift(ctx.mesh, g, +1), None


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    return _AllToAll.apply(x, mesh)


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    return _Psum.apply(x, mesh)


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("pmax has no gradient: take it under no_grad "
                           "(the reference's stop_gradient)")
    return _all_reduce(mesh, x, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    return _AllGather.apply(x, mesh)


def ring_shift(x: torch.Tensor, mesh) -> torch.Tensor:
    return _RingShift.apply(x, mesh)


@torch.no_grad()
def pmean_tree(tree, mesh):
    """The mean over the ranks of every float32 leaf of a
    `{"layers": [{name: tensor}]}` tree, through one all-reduce of the
    leaves laid end to end."""
    flat = leaves(tree)
    total = _all_reduce(mesh, torch.cat([t.reshape(-1) for t in flat]),
                        dist.ReduceOp.SUM) / mesh.size
    parts = iter(total.split([t.numel() for t in flat]))
    return {"layers": [{name: next(parts).reshape(t.shape)
                        for name, t in layer.items()}
                       for layer in tree["layers"]]}
