"""Gradient compression with error feedback: the twin of
repro/optim/compress.py over the port's `{"layers": [{name: tensor}]}`
parameter tree.

int8 uniform quantisation per tensor (scale = max|x| / 127, round half to
even, clipped to +-127) with an error-feedback accumulator (Seide et al. /
Karimireddy et al.): the quantisation residual is carried to the next step,
so compression error acts like a delayed gradient instead of a bias.
`core/wire.py`'s `codec_grad_reduce` routes its int8 branch through
`compressed_psum` (k partitions) or `compress` / `decompress` (one), and
`wire.ef_init` through `compress_init`.

The reference runs one partition a `vmap` lane; here a gradient tree may
hold the k partitions as the leading dimension of every leaf
(`stacked=True`), and then each partition is quantised with a scale of its
own (one per lane, as in the reference), never one scale over the stack.
`compressed_psum` is the reference's `lax.pmean` over the lanes: the mean
over that dimension, or over the ranks of a mesh in the dist mode, where
each rank holds its own gradient and its own carry.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.collectives import pmean_tree
from repro_torch.optim.adam import tree_map

Params = Any


class CompressionState(NamedTuple):
    error: Params  # error-feedback accumulator, same tree as grads (f32)


def _per_partition(scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`scale` ([] or [k]) shaped to broadcast against `like` ([k, ...])."""
    return scale.reshape(scale.shape + (1,) * (like.dim() - scale.dim()))


def quantise(x: torch.Tensor, *, stacked: bool = False):
    """(int8 payload, float32 scale) of `x`: scale = max(max|x|, 1e-12) / 127
    over the whole tensor ([] scale), or over each partition x[j] of a
    stacked tensor ([k] scales). Autograd reaches `x` only through the
    scale: the rounding has zero derivative and the int8 cast ends the
    graph, as `jnp.round` and `astype(int8)` do in the reference."""
    x = x.to(torch.float32)
    mag = x.abs()
    amax = mag.reshape(x.shape[0], -1).amax(1) if stacked else mag.amax()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / _per_partition(scale, x)), -127, 127)
    return q.to(torch.int8), scale


def dequantise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q * scale in float32 (a [k] scale applies partition by partition)."""
    return q.to(torch.float32) * _per_partition(scale, q)


def compress_init(grads_like: Params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def compress(grads: Params, state: CompressionState, *,
             stacked: bool = False):
    """Returns (quantised int8 tree, per-leaf scales, new state)."""

    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, scale = quantise(corrected, stacked=stacked)
        return q, scale, corrected - dequantise(q, scale)

    out = tree_map(one, grads, state.error)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), pick(1), CompressionState(error=pick(2))


def decompress(qs: Params, scales: Params, dtype=torch.float32) -> Params:
    return tree_map(lambda q, s: dequantise(q, s).to(dtype), qs, scales)


def compressed_psum(grads: Params, state: CompressionState, mesh=None):
    """Data-parallel gradient mean with int8 error-feedback compression:
    each partition quantises its own gradient, the mean is taken over the
    dequantised views (the reference's `pmean`: the sum over the
    partitions over k), and the residual stays with its partition in the
    error-feedback state. Without `mesh` the gradients are stacked
    [k, ...]; with one (launch/mesh.py), they are this rank's, and the
    mean runs over the ranks (the reference's `axis`)."""
    if mesh is not None:
        qs, scales, new_state = compress(grads, state)
        return pmean_tree(decompress(qs, scales), mesh), new_state
    qs, scales, new_state = compress(grads, state, stacked=True)
    deq = decompress(qs, scales)
    return tree_map(lambda g: g.sum(0) / g.shape[0], deq), new_state
