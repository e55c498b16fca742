# Copy of repro/gnn/sampling.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Distributed k-hop neighborhood sampling (DistDGL regime).

Sampling is data-dependent pointer chasing — it stays on the host (NumPy),
exactly where DistDGL runs it (CPU sampler processes), overlapped with device
compute. The sampled message-flow graphs (MFGs) are padded to static shapes
so the device step compiles once.

Layout convention (same as DGL's MFGs): the destination nodes of layer i are
a *prefix* of its source nodes, so self-features are `h_prev[:n_dst]`.

Per-step metrics mirror the paper's §5.1: number of input vertices, number of
remote input vertices (owned by another worker — the network-fetch set),
edges of the computation graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.kernels.tiling import (
    DEFAULT_BLOCK_E,
    DEFAULT_TILE_V,
    prepare_tiled_edges,
    tiled_shape,
)

# Paper §5.1: fanouts per number of layers.
PAPER_FANOUTS = {2: (25, 20), 3: (15, 10, 5), 4: (10, 10, 5, 5)}


class LayerPad(NamedTuple):
    n_src: int
    n_dst: int
    n_edges: int

    def tiled_plan(self, fanout: int,
                   tile_v: int = DEFAULT_TILE_V,
                   block_e: int = DEFAULT_BLOCK_E) -> tuple[int, int]:
        """Static (n_tiles, per_tile) of this layer's tiled-aggregation
        layout. A row tile holds <= tile_v destination rows, each with at
        most `fanout` sampled in-edges, so per_tile is bounded without ever
        looking at a concrete batch — the pad plan stays static."""
        _, n_tiles = tiled_shape(self.n_dst + 1, tile_v)  # + padding sink row
        cap = min(self.n_edges, tile_v * fanout)
        per_tile = max(-(-cap // block_e), 1) * block_e
        return n_tiles, per_tile


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """Static padding plan for a (seeds, fanouts) configuration."""

    seeds: int
    fanouts: tuple[int, ...]
    layers: tuple[LayerPad, ...]  # ordered input-side -> output-side

    @classmethod
    def build(cls, seeds: int, fanouts: Sequence[int]) -> "SamplePlan":
        # layer L-1 consumes frontier_{L-1} -> produces the seed outputs.
        # Worst case frontier growth: n_{i+1} = n_i * (1 + fanout_i).
        fanouts = tuple(int(f) for f in fanouts)
        n = [seeds]
        for f in reversed(fanouts):  # from output side to input side
            n.append(n[-1] * (1 + f))
        n = list(reversed(n))  # n[0] = input frontier bound, n[-1] = seeds
        layers = []
        for i, f in enumerate(fanouts):
            n_src = n[i]
            n_dst = n[i + 1]
            layers.append(LayerPad(n_src=n_src, n_dst=n_dst, n_edges=n_dst * f))
        return cls(seeds=seeds, fanouts=fanouts, layers=tuple(layers))


class SampledLayer(NamedTuple):
    esrc: np.ndarray  # [n_edges] positions into this layer's src frontier
    edst: np.ndarray  # [n_edges] positions into the dst prefix
    emask: np.ndarray
    n_dst: np.ndarray  # scalar int32 (true dst count)
    sampled_deg: np.ndarray  # [n_dst_pad] float32: true #sampled in-neighbors
    # tiled aggregation layout (kernels.tiling.prepare_tiled_edges over the
    # real edges of this MFG layer; static shape = LayerPad.tiled_plan).
    # None unless the sampler was asked for it (tiled/pallas backends only).
    agg_order: Optional[np.ndarray] = None  # [E_tiled] int32 (pad -> n_edges)
    agg_ldst: Optional[np.ndarray] = None   # [E_tiled] int32 (pad -> tile_v)


class SampledBatch(NamedTuple):
    """One worker's mini-batch, padded to the plan. All numpy."""

    input_ids: np.ndarray     # [n_src_pad0] global vertex ids (pad -> -1)
    input_mask: np.ndarray
    layers: tuple[SampledLayer, ...]
    seed_labels: np.ndarray   # [seeds]
    seed_mask: np.ndarray
    # metrics
    num_input: int
    num_remote: int
    num_edges: int


def _sample_hop(
    indptr: np.ndarray,
    indices: np.ndarray,
    frontier: np.ndarray,
    fanout: int,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised fanout sampling without replacement for a whole frontier.

    Returns (src_global_ids, dst_positions). O(E_frontier log E_frontier):
    expand all adjacency entries, give each a random key, keep the `fanout`
    smallest keys per destination segment.
    """
    deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
    total = int(deg.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    cum = np.cumsum(deg) - deg
    # seg_off = offset within each destination's adjacency segment; after the
    # per-segment sort below it is ALSO the position within each dst group
    # (both are 0..deg-1 ramps over the same segments), so one repeat serves
    # both uses — tests pin the output against the two-repeat formulation
    seg_off = np.arange(total, dtype=np.int64) - np.repeat(cum, deg)
    all_pos = np.repeat(indptr[frontier], deg) + seg_off
    all_src = indices[all_pos].astype(np.int64)
    all_dst = np.repeat(np.arange(frontier.shape[0], dtype=np.int64), deg)
    keys = rng.random(total)
    order = np.lexsort((keys, all_dst))
    keep = order[seg_off < fanout]
    return all_src[keep], all_dst[keep]


def sample_blocks(
    graph: Graph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    plan: SamplePlan,
    rng: np.random.Generator,
    labels: np.ndarray,
    owner: Optional[np.ndarray] = None,
    worker: int = 0,
    tiled_layout: bool = False,
) -> SampledBatch:
    """Sample a k-hop MFG stack for `seeds` (innermost hop first in output).

    `tiled_layout` additionally attaches the per-layer tiled aggregation
    layout (agg_order/agg_ldst) — only the tiled/pallas backends read it, so
    the default scatter path skips the extra host argsort per layer."""
    indptr, indices = graph.csr()
    fanouts = tuple(int(f) for f in fanouts)

    frontier = np.asarray(seeds, dtype=np.int64)
    layer_edges: list[tuple[np.ndarray, np.ndarray]] = []  # (src_gid, dst_pos)
    frontiers: list[np.ndarray] = [frontier]
    in_frontier = np.zeros(graph.num_vertices, dtype=bool)
    in_frontier[frontier] = True

    # outermost loop runs from the seed side inward (hop L-1 ... 0)
    for f in reversed(fanouts):
        src_g, dst_p = _sample_hop(indptr, indices, frontier, f, rng)
        layer_edges.append((src_g, dst_p))
        # next frontier = dst prefix ∪ new sources (prefix convention)
        extra = np.unique(src_g[~in_frontier[src_g]])
        in_frontier[extra] = True
        frontier = np.concatenate([frontier, extra])
        frontiers.append(frontier)

    # frontiers[i] = frontier consumed by hop i counted from the seed side;
    # reverse everything into input-side-first order.
    layer_edges.reverse()
    frontiers.reverse()  # frontiers[0] = deepest (input) frontier

    layers: list[SampledLayer] = []
    pos_of = np.full(graph.num_vertices, -1, dtype=np.int64)
    for i, (src_g, dst_p) in enumerate(layer_edges):
        pad = plan.layers[i]
        src_frontier = frontiers[i]
        dst_count = frontiers[i + 1].shape[0]
        # map global src ids to positions in src_frontier (vectorised)
        pos_of[src_frontier] = np.arange(src_frontier.shape[0])
        src_pos = pos_of[src_g]
        n_e = src_pos.shape[0]
        if n_e > pad.n_edges:  # can't happen by construction, but guard
            raise AssertionError("sample overflow vs plan")
        esrc = np.full(pad.n_edges, pad.n_src, dtype=np.int32)  # pad -> dummy
        edst = np.full(pad.n_edges, pad.n_dst, dtype=np.int32)
        emask = np.zeros(pad.n_edges, dtype=bool)
        esrc[:n_e] = src_pos
        edst[:n_e] = dst_p
        emask[:n_e] = True
        deg = np.zeros(pad.n_dst + 1, dtype=np.float32)
        np.add.at(deg, dst_p, 1.0)
        agg_order = agg_ldst = None
        if tiled_layout:
            _, per_tile = pad.tiled_plan(fanouts[i])
            agg_order, agg_ldst, _ = prepare_tiled_edges(
                edst, pad.n_dst + 1, per_tile=per_tile, valid=emask,
            )
            agg_order = agg_order.astype(np.int32)
        layers.append(
            SampledLayer(
                esrc=esrc, edst=edst, emask=emask,
                n_dst=np.int32(dst_count), sampled_deg=deg,
                agg_order=agg_order,
                agg_ldst=agg_ldst,
            )
        )

    inputs = frontiers[0]
    pad0 = plan.layers[0].n_src
    input_ids = np.full(pad0, -1, dtype=np.int64)
    input_ids[: inputs.shape[0]] = inputs
    input_mask = input_ids >= 0

    num_remote = int((owner[inputs] != worker).sum()) if owner is not None else 0
    seed_labels = np.full(plan.seeds, -1, dtype=np.int32)
    seed_labels[: seeds.shape[0]] = labels[seeds]
    seed_mask = np.zeros(plan.seeds, dtype=bool)
    seed_mask[: seeds.shape[0]] = True

    return SampledBatch(
        input_ids=input_ids,
        input_mask=input_mask,
        layers=tuple(layers),
        seed_labels=seed_labels,
        seed_mask=seed_mask,
        num_input=int(inputs.shape[0]),
        num_remote=num_remote,
        num_edges=int(sum(int(l.emask.sum()) for l in layers)),
    )
