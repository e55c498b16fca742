"""Synchronisation strategies for distributed full-graph GNN layers.

Twin of repro/gnn/sync.py (Local, Dense, Halo and Ring, each with its wire
codec). The reference runs one partition per `vmap` lane; here the k
partitions are a leading dimension of every tensor, so a collective is a
tensor op over that dimension:

    edge_aggregate(blk, payload [k, n, d], msg_fn, *, reduce, backend)
        -> [k, n, d], complete over the symmetrised adjacency
    psum(v [k, ...]) -> [...], the sum over the partitions (the
        reference's `lax.psum` over its device axis)

`msg_fn(src_rows, dst_rows, edge_mask)` sees the payload rows gathered at
each edge's source, the edge's destination as a row of the flattened
[k*n] row space (for destination-side tables such as GAT's softmax shift)
and the edge mask; n is the rows of a partition's block, the last of them
the dummy/padding sink.

All k partitions aggregate in ONE `ops.aggregate` call (Ring: one a ring
stage). For the tiled backends that works because every partition's layout
has the same `per_tile`: stacked, the k layouts are one layout over
k * rows_padded rows (`local_dst` is tile-relative), so one kernel launch
serves them all.

  LocalSync — k=1: the partial aggregates are already complete.
  DenseSync — the naive baseline: each partition's partial placed at its
              global rows of a [k, V+1, d] buffer, summed over the
              partitions (the reference's `lax.psum` of its [V+1, d]
              buffer), gathered back at every replica.
  HaloSync  — static-routed replica completion from the partition book's
              replica lists. The reference's `lax.all_to_all(split_axis=0,
              concat_axis=0)` over the stacked [k(sender), k(bucket), B, d]
              buffer is `send.transpose(0, 1)`; its `.at[].add/max/set`
              are index_add_ / scatter_reduce_("amax") / index assignment on the
              flattened [k*n] rows. These update the fresh aggregate in
              place.
  RingSync  — 1.5D block rotation over a `BlockRowBook` (`RingBlock`): at
              ring stage s partition p holds block (p+s) mod k of the
              payload (the reference's `lax.ppermute` ring after s hops)
              and aggregates its pre-rotated chunk (p, s); the k stages
              run in order, summed (or maxed) in stage order.

Every strategy carries a `codec` (core/wire.py; None is fp32, the
identity, so the default path is the codec-free code). Under a lossy codec
each partition's payload is encoded with its own scale and decoded before
it is used, where the reference encodes before its collective and decodes
after: Dense encodes a partition's [V+1, d] slice before the sum over the
partitions (its max is not encoded); Halo encodes the [k(sender), k, B, d]
buffer, one scale a sender, and fills the max's masked slots with 0.0, not
-1e30 (the receiver re-masks them); Ring encodes each partition's [n, d]
payload once an aggregate, and every stage, stage 0 included, reads the
decoded view, decoded anew a stage as in the reference (the same bits,
and under bf16 the reference's backward: each stage's cotangent rounded to
bf16 on its own); Local moves nothing. `models.forward` resets the
aggregate ordinal (`reset_layer_counter`), and each `edge_aggregate` takes
the next one: the depth `VariableRatioCodec` ramps on. The accounting
(`sync_wire_bytes_per_round`, `collective_budget`) prices each partition's
encoded buffer by `codec.wire_bytes`, as the reference does.

No completion's result depends on the order of float atomics: every
`index_add_` / `scatter_reduce_` a completion issues adds at most one real
value to a row (the sums and the broadcast take the real slots alone; the
max's pads write the dummy rows with its identity), and
sums over partitions or stages are reductions over a stacked dimension or
adds in a fixed order. On the card the edge gathers' backward is
PyTorch's sort-based `index_put_` accumulate, which repeats, so a tiled
full-batch step repeats bit for bit as it runs; the scatter backend's own
`index_add_` (kernels/ref.py) adds in atomic order, and on the CPU the
gathers' backward adds in thread order, unless PyTorch's deterministic
algorithms are on, as they are for every training step
(`minibatch.repeatable_step`).

The dist mode (gnn/fullbatch.py, mode="dist": one process a partition,
the reference's shard_map) runs the same strategies on one rank's block,
built with `part` as a stack of one: `DistDenseSync`, `DistHaloSync` and
`DistRingSync` keep every tensor op above and turn the sums and exchanges
over the stacked dimension into collectives over a `launch.mesh.Mesh`
(core/collectives.py): Dense's sum (max) over the partitions is one
all-reduce sum (max) of the rank's [V+1, d] buffer; Halo's exchange is one
all-to-all of its [k, B, d] send buffer (a lossy codec's sender scales
all-gathered); Ring holds one payload block at a time and shifts it one
rank down the ring between stages, k-1 shifts an aggregate; the loss's
psum is an all-reduce. `make_sync` takes the mesh.

Under an installed tracer (obs/trace.py) Dense, Halo and Ring record each
collective the reference's strategies record (`_record_collective`), at
the same logical points and with the reference's byte conventions, once
per forward pass (the reference records once, when jax traces the step).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.partition_book import BlockRowBook, EdgePartitionBook
from repro_torch.core.wire import Codec, as_codec
from repro_torch.kernels import ops
from repro_torch.kernels.tiling import tiled_shape
from repro_torch.obs.trace import get_tracer

# forward-pass ordinals for the recorded collectives (see _record_collective)
_FORWARDS = itertools.count()


def _nbytes(x) -> int:
    """Byte size of a tensor (0 for None). On a stacked [k, ...] tensor
    that is the k partitions' bytes together: the reference's per-device
    size times k."""
    if x is None:
        return 0
    return x.numel() * x.element_size()


def _record_collective(sync, kind: str, cluster_bytes: int,
                       wire_bytes: Optional[int] = None, *,
                       layer: int = 0) -> None:
    """Report one collective of `sync`'s forward pass to the installed
    tracer, at the reference's logical points (repro/gnn/sync.py
    `_record_collective`) and with its byte conventions: cluster bytes are
    the per-device output size times k, wire bytes k times the per-device
    encoded payload (+ meta). The reference records once, when jax traces
    the step; the stacked partitions run eagerly, so every forward pass
    records its own set, stamped with the pass's ordinal (`forward`), and
    `obs.reconcile` compares one pass. Loss-scalar sums are not recorded,
    as in the reference."""
    tr = get_tracer()
    if tr.enabled:
        fwd = getattr(sync, "_forward", None)
        if fwd is None:  # a layer run outside `models.forward`
            fwd = next(_FORWARDS)
            object.__setattr__(sync, "_forward", fwd)
        tr.collective(kind, cluster_bytes, wire_bytes=wire_bytes,
                      layer=layer, forward=fwd)


class Block(NamedTuple):
    """The k partitions' static device state, stacked [k, ...] (one
    rank's: its partition alone, a stack of one).

    The first fields are the reference's `Block`; the rest are the same
    tables flattened once at build time for the stacked aggregate."""

    x: torch.Tensor            # [k, n, F] float32 features
    labels: torch.Tensor       # [k, n] int32 (-1 pad)
    train_mask: torch.Tensor   # [k, n] bool
    esrc: torch.Tensor         # [k, Eloc] int64 local src (pad -> dummy row)
    edst: torch.Tensor         # [k, Eloc] int64 local dst
    emask: torch.Tensor        # [k, Eloc] bool
    degree: torch.Tensor       # [k, n] float32 global symmetric degree
    master: torch.Tensor       # [k, n] bool
    vmask: torch.Tensor        # [k, n] bool
    send_idx: torch.Tensor     # [k, k, B] int64
    send_mask: torch.Tensor    # [k, k, B] bool
    recv_idx: torch.Tensor     # [k, k, B] int64
    recv_mask: torch.Tensor    # [k, k, B] bool
    vglobal: torch.Tensor      # [k, n] int64 (pad -> V)
    # symmetrised edge list [edst | esrc] over the flattened row spaces
    sym_src: torch.Tensor      # [k*2*Eloc] int64 source row in [k*n]
    sym_dst: torch.Tensor      # [k*2*Eloc] int64 destination row in [k*n]
    sym_mask: torch.Tensor     # [k*2*Eloc] bool
    agg_dst: torch.Tensor      # [k*2*Eloc] int64 destination row in [k*R]
    # the k tiled layouts folded into one (empty without tiled_layout):
    # gather indices into the k*2*Eloc messages (pad -> k*2*Eloc) and
    # tile-relative rows (pad -> tile_v), over k*R rows
    agg_order: torch.Tensor    # [k*E_tiled] int64
    agg_ldst: torch.Tensor     # [k*E_tiled] int32
    rows_padded: int           # R = tiled_shape(n)[0]
    num_vertices: int          # V: vglobal's pad value, Dense's dummy row
    # the completions' real slots, pads left out (`_completion_tables`)
    halo_rows: tuple           # per sender: [real] int64 rows in [k*n]
    halo_slots: tuple          # per sender: [real] int64 slots in [k*B]
    bcast_rows: torch.Tensor   # [real] int64 mirror rows in [k*n]
    bcast_slots: torch.Tensor  # [real] int64 slots in [k*k*B]
    dense_src: torch.Tensor    # [real] int64 real rows in [k*n]
    dense_rows: torch.Tensor   # [real] int64 their rows in [k*(V+1)]


def _completion_tables(book: EdgePartitionBook, vg: np.ndarray,
                       parts: np.ndarray) -> dict:
    """The rows each completion writes and where its values sit, real
    slots only, for the partitions `parts` (all k stacked, or one rank's).
    The pad slots carry the reduce's identity to a dummy row,
    so leaving them out changes no real row, and under PyTorch's
    deterministic algorithms (the training step's) an `index_add_` or an
    index assignment sorts its indices and walks each row's duplicates one
    after another: thousands of pads on one dummy row made the halo and
    dense steps slower than their atomic versions. Rows and slots count
    over the selected partitions, p its position in `parts`. Halo's
    reduce, sender i: receiver p's row `recv_idx[p, i, b]` takes slot
    p*B + b of what i sent; its broadcast writes mirror row
    `send_idx[p, j, b]` of partition p from slot (p*k + j)*B + b of the
    exchanged buffer; Dense places partition p's real row r at
    p*(V+1) + vglobal[p, r]."""
    k, n = book.k, book.v_max + 1
    part = np.arange(len(parts), dtype=np.int64)
    recv_mask = book.recv_mask[parts]
    send_mask = book.send_mask[parts]
    recv_rows = part[:, None, None] * n + book.recv_idx[parts].astype(np.int64)
    halo_rows, halo_slots = [], []
    for i in range(k):
        slots = np.flatnonzero(recv_mask[:, i])
        halo_slots.append(slots)
        halo_rows.append(recv_rows[:, i].reshape(-1)[slots])
    send_rows = part[:, None, None] * n + book.send_idx[parts].astype(np.int64)
    bcast_slots = np.flatnonzero(send_mask)
    dense_src = np.flatnonzero(book.vmask[parts])
    g_rows = part[:, None] * (book.num_vertices + 1) + vg[parts]
    return {"halo_rows": halo_rows, "halo_slots": halo_slots,
            "bcast_rows": send_rows.reshape(-1)[bcast_slots],
            "bcast_slots": bcast_slots, "dense_src": dense_src,
            "dense_rows": g_rows.reshape(-1)[dense_src]}


def _selected(book, part: Optional[int]) -> np.ndarray:
    """The partitions a block holds: all k (the stacked sim), or `part`
    alone (one rank of the dist mode: the same tables and padding, its
    own slice)."""
    if part is None:
        return np.arange(book.k)
    if not 0 <= part < book.k:
        raise ValueError(f"partition {part} of a {book.k}-way book")
    return np.array([part])


def _host_rows(book, features, labels, train_mask, parts):
    """(x, labels, train mask, vglobal with pads -> V) of `parts`."""
    x = book.local_features(features.astype(np.float32))[parts]
    lab = book.local_labels(labels.astype(np.int32))[parts]
    safe = np.where(book.vglobal[parts] >= 0, book.vglobal[parts], 0)
    tm = train_mask[safe] & book.vmask[parts]
    vg = np.where(book.vglobal >= 0, book.vglobal, book.num_vertices)
    return x, lab, tm, vg


def build_blocks(
    book: EdgePartitionBook,
    features: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    *,
    device: torch.device,
    part: Optional[int] = None,
) -> Block:
    """Block on `device` from a partition book + global node data: the k
    partitions stacked, or with `part` that partition alone as a stack of
    one (a rank's block in the dist mode; the halo tables keep their k
    buckets)."""
    parts = _selected(book, part)
    kk, n = len(parts), book.v_max + 1
    x, lab, tm, vg = _host_rows(book, features, labels, train_mask, parts)

    rows_padded, _ = tiled_shape(n)
    e2 = 2 * book.e_max
    part_ = np.arange(kk, dtype=np.int64)[:, None]
    esrc, edst, emask = book.esrc[parts], book.edst[parts], book.emask[parts]
    src2 = np.concatenate([esrc, edst], axis=1).astype(np.int64)
    dst2 = np.concatenate([edst, esrc], axis=1).astype(np.int64)
    mask2 = np.concatenate([emask, emask], axis=1)
    order = book.agg_order[parts].astype(np.int64)
    order = np.where(order == e2, kk * e2, part_ * e2 + order)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    tables = _completion_tables(book, vg, parts)
    return Block(
        x=t(x), labels=t(lab), train_mask=t(tm),
        esrc=t(esrc, torch.int64), edst=t(edst, torch.int64),
        emask=t(emask), degree=t(book.degree[parts]),
        master=t(book.master[parts]), vmask=t(book.vmask[parts]),
        send_idx=t(book.send_idx[parts], torch.int64),
        send_mask=t(book.send_mask[parts]),
        recv_idx=t(book.recv_idx[parts], torch.int64),
        recv_mask=t(book.recv_mask[parts]),
        vglobal=t(vg[parts], torch.int64),
        sym_src=t((part_ * n + src2).reshape(-1)),
        sym_dst=t((part_ * n + dst2).reshape(-1)),
        sym_mask=t(mask2.reshape(-1)),
        agg_dst=t((part_ * rows_padded + dst2).reshape(-1)),
        agg_order=t(order.reshape(-1)),
        agg_ldst=t(book.agg_ldst[parts].reshape(-1), torch.int32),
        rows_padded=rows_padded,
        num_vertices=book.num_vertices,
        halo_rows=tuple(t(r) for r in tables["halo_rows"]),
        halo_slots=tuple(t(s) for s in tables["halo_slots"]),
        bcast_rows=t(tables["bcast_rows"]),
        bcast_slots=t(tables["bcast_slots"]),
        dense_src=t(tables["dense_src"]),
        dense_rows=t(tables["dense_rows"]),
    )


class _CodecSync:
    """Wire-codec plumbing shared by every strategy. Strategies are frozen
    dataclasses, so the aggregate ordinal lives behind `object.__setattr__`
    (the reference's `_CodecSync`): `reset_layer_counter` at the top of a
    forward, `_take_layer` at each `edge_aggregate`."""

    def _codec(self) -> Codec:
        return as_codec(self.codec)

    def _cluster(self, nbytes: int) -> int:
        """The cluster bytes of a stacked buffer: its own (it holds the k
        partitions' buffers)."""
        return nbytes

    def reset_layer_counter(self) -> None:
        object.__setattr__(self, "_agg_layer", 0)
        object.__setattr__(self, "_forward", next(_FORWARDS))

    def _take_layer(self) -> int:
        layer = int(getattr(self, "_agg_layer", 0))
        object.__setattr__(self, "_agg_layer", layer + 1)
        object.__setattr__(self, "_cur_layer", layer)
        return layer

    def _wire(self, buf: torch.Tensor) -> torch.Tensor:
        """`buf` [k, ...] as the receivers see it: each partition's slice
        encoded with its own scale at this aggregate's ordinal, then
        decoded. The fp32 codec returns `buf` itself."""
        codec = self._codec()
        payload, meta = codec.encode(
            buf, layer=getattr(self, "_cur_layer", 0), stacked=True)
        return codec.decode(payload, meta)


class _PartialAggSync(_CodecSync):
    """Shared `edge_aggregate` for the partial-aggregate family: reduce the
    messages over every partition's symmetrised local edge list, then
    complete the partials with the strategy's reduce + broadcast pair."""

    def edge_aggregate(self, blk: Block, payload: torch.Tensor, msg_fn, *,
                       reduce: str = "sum", backend: str = "scatter"):
        self._take_layer()
        k, n, d = payload.shape
        messages = msg_fn(payload.reshape(k * n, d)[blk.sym_src],
                          blk.sym_dst, blk.sym_mask)
        rows = k * blk.rows_padded
        agg = ops.aggregate(
            messages, blk.agg_dst, rows,
            edge_order=blk.agg_order, local_dst=blk.agg_ldst,
            backend=backend, reduce=reduce,
        )
        agg = agg.reshape(k, blk.rows_padded, -1)[:, :n].contiguous()
        agg = self.reduce_max(agg) if reduce == "max" else self.reduce_sum(agg)
        return self.broadcast(agg)


@dataclasses.dataclass(frozen=True)
class LocalSync(_PartialAggSync):
    """k=1: partial aggregates are already complete (codec: nothing
    moves)."""

    codec: Optional[Union[str, Codec]] = None

    def reduce_sum(self, h):
        return h

    def reduce_max(self, h):
        return h

    def broadcast(self, h):
        return h

    def psum(self, v):
        return v.sum(0)


def _flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[k, ...] partition-local row ids -> rows of the flattened [k*n]."""
    k = idx.shape[0]
    offs = torch.arange(k, device=idx.device).reshape((k,) + (1,) * (idx.dim() - 1))
    return (idx + offs * n).reshape(-1)


@dataclasses.dataclass(frozen=True)
class DenseSync(_PartialAggSync):
    """Naive baseline: materialise the global vertex state and sum it over
    the partitions. Each partition owns one [V+1, d] slice of a stacked
    buffer, in which it holds a vertex at most once, so the placement adds
    at most one real value to a row; the sum over the partitions is a
    reduction over the stacked dimension, not adds into one [V+1, d]
    buffer whose replicas would land in atomic order. A lossy codec
    encodes each partition's slice before the sum (the reduce sums the
    decoded views, as the reference's psum of its dequantised buffer)."""

    blk: Block
    codec: Optional[Union[str, Codec]] = None

    def _stacked(self, h, fill):
        """[k*(V+1), d] filled with `fill` and the row indices of each
        partition's rows in it (pads -> that partition's dummy row V)."""
        blk = self.blk
        k, _, d = h.shape
        g_rows = blk.num_vertices + 1
        return (h.new_full((k * g_rows, d), fill),
                _flat_rows(blk.vglobal, g_rows), g_rows)

    def reduce_sum(self, h):
        blk = self.blk
        k, n, d = h.shape
        buf, _, g_rows = self._stacked(h, 0.0)
        # the real rows only (`_completion_tables`): pads would add zeros
        part = h.reshape(k * n, d).index_select(0, blk.dense_src)
        g = self._wire(buf.index_add(0, blk.dense_rows, part)
                       .reshape(k, g_rows, d))
        # wire_bytes=None: the reduce moves the decoded f32 view, so the
        # transport formula (2x encoded) intentionally diverges
        g = self._over_parts(g, "sum")
        return g[blk.vglobal] * blk.vmask[..., None]

    def reduce_max(self, h):
        blk = self.blk
        k, n, d = h.shape
        buf, rows, g_rows = self._stacked(h, -1e30)
        part = torch.where(blk.vmask[..., None], h, -1e30).reshape(k * n, d)
        buf.scatter_reduce_(0, rows[:, None].expand(-1, d), part,
                            reduce="amax", include_self=True)
        g = self._over_parts(buf.reshape(k, g_rows, d), "max")
        return torch.where(blk.vmask[..., None], g[blk.vglobal], h)

    def _over_parts(self, g, reduce: str):
        """The [V+1, d] sum (or max) of the partitions' [k, V+1, d] slices
        (the reference's psum / pmax of its buffer): a reduction over the
        stacked dimension."""
        _record_collective(self, "all-reduce", _nbytes(g),
                           layer=getattr(self, "_cur_layer", 0))
        return g.amax(0) if reduce == "max" else g.sum(0)

    def broadcast(self, h):
        # reduce already produced globally-complete values at every replica
        return h

    def psum(self, v):
        return v.sum(0)


@dataclasses.dataclass(frozen=True)
class HaloSync(_PartialAggSync):
    """Static-routed replica synchronisation (the paper-faithful path).

    reduce_*: every mirror packs its partial rows for each master partition
    into fixed buckets; after the exchange, masters scatter-accumulate, one
    sender at a time in sender order. Within one (receiver, sender) pair
    the real slots are distinct master rows (the sum takes those alone;
    the max's pads hit the dummy row with its identity), so no row takes
    two values in one call: the completion does not depend on the order
    of atomic adds, although a master row receives from several mirrors.
    broadcast: the exact reverse routing pushes completed rows back, each
    mirror row written once.
    The codec brackets `_exchange`: one scale a sender over its [k, B, d]
    buffer, and received bucket i decoded with sender i's scale."""

    blk: Block
    codec: Optional[Union[str, Codec]] = None

    def _exchange(self, buf: torch.Tensor) -> torch.Tensor:
        # buf [k(sender), k(bucket), B, d]; result[j, i] = what i sent to j
        codec = self._codec()
        lay = getattr(self, "_cur_layer", 0)
        payload, meta = codec.encode(buf, layer=lay, stacked=True)
        pb, mb = _nbytes(payload), _nbytes(meta)
        # the stacked payload is the k devices' [k, B, d] buffers: the
        # reference's cluster bytes (k x per-device output); wire bytes
        # add the k sender scales
        _record_collective(self, "all-to-all", pb, pb + mb, layer=lay)
        if meta is not None:
            # every device gathers the k sender scales
            _record_collective(self, "all-gather", buf.shape[0] * mb,
                               layer=lay)
        return codec.decode(payload, meta).transpose(0, 1)

    def _gather(self, h, idx):
        k, n, d = h.shape
        return h.reshape(k * n, d)[_flat_rows(idx, n)].reshape(idx.shape + (d,))

    def _per_sender(self, h, recv):
        """(flat [k*n, d] view of h, [(rows, values)] one pair a sender)."""
        k, n, d = h.shape
        senders = self.blk.recv_idx.shape[1]
        rows = _flat_rows(self.blk.recv_idx, n).reshape(k, senders, -1)
        return h.reshape(k * n, d), [
            (rows[:, i].reshape(-1), recv[:, i].reshape(-1, d))
            for i in range(senders)]

    def reduce_sum(self, h):
        blk = self.blk
        k, n, d = h.shape
        send = self._gather(h, blk.send_idx) * blk.send_mask[..., None]
        recv = self._exchange(send)
        flat = h.reshape(k * n, d)
        # sender by sender, its real slots only (`_completion_tables`):
        # the pads would add zeros to the dummy rows
        for i, (rows, slots) in enumerate(zip(blk.halo_rows,
                                              blk.halo_slots)):
            flat.index_add_(0, rows, recv[:, i].reshape(-1, d)
                            .index_select(0, slots))
        return flat.reshape(h.shape)

    def reduce_max(self, h):
        blk = self.blk
        # a lossy codec sends 0.0 in masked slots: an extreme fill would
        # erase a per-tensor int8 scale (the receiver re-masks either way)
        fill = -1e30 if self._codec().lossless else 0.0
        send = torch.where(blk.send_mask[..., None],
                           self._gather(h, blk.send_idx), fill)
        recv = self._exchange(send)
        recv = torch.where(blk.recv_mask[..., None], recv, -1e30)
        flat, pairs = self._per_sender(h, recv)
        for rows, vals in pairs:
            flat.scatter_reduce_(0, rows[:, None].expand_as(vals), vals,
                                 reduce="amax", include_self=True)
        return flat.reshape(h.shape)

    def broadcast(self, h):
        blk = self.blk
        k, n, d = h.shape
        send = self._gather(h, blk.recv_idx) * blk.recv_mask[..., None]
        recv = self._exchange(send)
        # each mirror row is written once, from its real slot
        # (`_completion_tables`); the pad slots would rewrite a dummy row
        flat = h.reshape(k * n, d)
        flat[blk.bcast_rows] = recv.reshape(-1, d).index_select(
            0, blk.bcast_slots)
        return flat.reshape(k, n, d)

    def psum(self, v):
        return v.sum(0)


class RingBlock(NamedTuple):
    """The k block rows' static device state, stacked [k, ...] (one
    rank's: its block row alone, a stack of one).

    The first fields are the reference's `RingBlock` (same row layout as
    `Block`: the dummy row is the last, v_block); the chunk tables are
    flattened once at build time, one row a ring stage s, over the k
    partitions' chunks (p, s) stacked."""

    x: torch.Tensor            # [k, n, F] float32 features of the OWNED block
    labels: torch.Tensor       # [k, n] int32 (-1 pad)
    train_mask: torch.Tensor   # [k, n] bool
    degree: torch.Tensor       # [k, n] float32 global symmetric degree
    master: torch.Tensor       # [k, n] bool (== vmask: single-owner layout)
    vmask: torch.Tensor        # [k, n] bool
    vglobal: torch.Tensor      # [k, n] int64 (pad -> V)
    # per stage s: chunk (p, s)'s edges; the source row of the payload block
    # partition p holds at stage s, (p+s) mod k, and the destination row of
    # p's own block, both in the flattened [k*n] row space (pad -> the dummy
    # rows), and the destination in [k*R] for the aggregate
    ring_src: torch.Tensor     # [k, k*c_max] int64
    ring_dst: torch.Tensor     # [k, k*c_max] int64
    ring_mask: torch.Tensor    # [k, k*c_max] bool
    agg_dst: torch.Tensor      # [k, k*c_max] int64
    # per stage, the k chunk layouts folded into one over k*R rows (empty
    # without tiled_layout): gather indices into the stage's k*c_max
    # messages (pad -> k*c_max) and tile-relative rows (pad -> tile_v)
    agg_order: torch.Tensor    # [k, k*E_tiled] int64
    agg_ldst: torch.Tensor     # [k, k*E_tiled] int32
    rows_padded: int           # R = tiled_shape(n)[0]


def build_ring_blocks(
    book: BlockRowBook,
    features: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    *,
    device: torch.device,
    part: Optional[int] = None,
) -> RingBlock:
    """RingBlock on `device` from a 1.5D book + global node data: the k
    block rows stacked, or with `part` that block row alone as a stack of
    one (a rank's block in the dist mode, whose chunk sources index the
    one payload block the rank holds at each stage)."""
    parts = _selected(book, part)
    k, kk, n, c = book.k, len(parts), book.v_block + 1, book.c_max
    x, lab, tm, vg = _host_rows(book, features, labels, train_mask, parts)

    rows_padded, _ = tiled_shape(n)
    # [p, s, ...] chunk tables -> stage-major [s, p, ...]
    esrc, edst, emask, order, ldst = (
        a[parts].transpose(1, 0, 2) for a in (
            book.chunk_esrc.astype(np.int64), book.chunk_edst.astype(np.int64),
            book.chunk_emask, book.chunk_agg_order.astype(np.int64),
            book.chunk_agg_ldst))
    stage = np.arange(k, dtype=np.int64)[:, None, None]
    part_ = np.arange(kk, dtype=np.int64)[None, :, None]
    order = np.where(order == c, kk * c, part_ * c + order)
    # the payload block a stage reads: (p+s) mod k of the stack, or the
    # rank's own held block
    held = ((parts[None, :, None] + stage) % k) if part is None else 0

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return RingBlock(
        x=t(x), labels=t(lab), train_mask=t(tm),
        degree=t(book.degree[parts]), master=t(book.vmask[parts]),
        vmask=t(book.vmask[parts]), vglobal=t(vg[parts], torch.int64),
        ring_src=t((held * n + esrc).reshape(k, -1)),
        ring_dst=t((part_ * n + edst).reshape(k, -1)),
        ring_mask=t(emask.reshape(k, -1)),
        agg_dst=t((part_ * rows_padded + edst).reshape(k, -1)),
        agg_order=t(order.reshape(k, -1)),
        agg_ldst=t(ldst.reshape(k, -1), torch.int32),
        rows_padded=rows_padded,
    )


@dataclasses.dataclass(frozen=True)
class RingSync(_CodecSync):
    """1.5D ring-pipelined aggregation (CAGNET-style block rotation).

    Stage s aggregates every partition's chunk (p, s) against the payload
    block it holds after s hops of the reference's `ppermute` ring, one
    `ops.aggregate` over the k stacked chunks; the stages run in order
    0..k-1 and accumulate by `+` (or `maximum`), out of place. Every row
    is owned exactly once, so there is no reduce/broadcast pair. The
    codec encodes each partition's block once an aggregate; what rotates
    is the encoded block, and each stage decodes it anew, as the
    reference's stages do: the values are the same bits at every stage,
    but under bf16 each stage's cotangent is rounded to bf16 on its own
    before the stages' cotangents are summed (in bf16), as in the
    reference's backward."""

    codec: Optional[Union[str, Codec]] = None

    def edge_aggregate(self, blk: RingBlock, payload: torch.Tensor, msg_fn,
                       *, reduce: str = "sum", backend: str = "scatter"):
        layer = self._take_layer()
        codec = self._codec()
        k, n, d = payload.shape
        stages = blk.ring_src.shape[0]
        enc, meta = codec.encode(payload, layer=layer, stacked=True)
        acc = None
        for s in range(stages):
            if s < stages - 1:
                # the reference's ppermute of the encoded block (and of its
                # scale) that ships stage s+1's block during stage s
                for x in (enc, meta):
                    if x is not None:
                        nb = self._cluster(_nbytes(x))
                        _record_collective(self, "collective-permute", nb,
                                           nb, layer=layer)
            flat = codec.decode(enc, meta).reshape(k * n, d)
            messages = msg_fn(flat[blk.ring_src[s]], blk.ring_dst[s],
                              blk.ring_mask[s])
            part = ops.aggregate(
                messages, blk.agg_dst[s], k * blk.rows_padded,
                edge_order=blk.agg_order[s], local_dst=blk.agg_ldst[s],
                backend=backend, reduce=reduce,
            ).reshape(k, blk.rows_padded, -1)[:, :n]
            if acc is None:
                acc = part
            else:
                acc = torch.maximum(acc, part) if reduce == "max" else acc + part
            if s < stages - 1:
                enc, meta = self._rotate(enc, meta)
        return acc.contiguous()

    def _rotate(self, enc, meta):
        """The blocks held at the next stage: the stack holds every block
        (stage s reads block (p+s) mod k through `ring_src`), so nothing
        moves."""
        return enc, meta

    def psum(self, v):
        return v.sum(0)


# ---------------------------------------------------------------------------
# The dist mode: one process a partition (the reference's shard_map)
# ---------------------------------------------------------------------------


class _OnRanks:
    """What the per-rank strategies share. Each rank holds its own
    partition as a stack of one (`build_blocks` / `build_ring_blocks` with
    `part`), so every tensor op of the stacked strategy runs as it is; the
    sums and exchanges over the stacked dimension become collectives over
    `mesh` (core/collectives.py), the reference's per-device code under
    `shard_map`. The tracer records what the sim records: cluster bytes
    are k times this rank's."""

    def _cluster(self, nbytes: int) -> int:
        return self.mesh.size * nbytes

    def psum(self, v):
        return collectives.psum(v.sum(0), self.mesh)


@dataclasses.dataclass(frozen=True)
class DistDenseSync(_OnRanks, DenseSync):
    """DenseSync on one rank: its [V+1, d] buffer summed (or maxed) over
    the ranks by one all-reduce, the reference's `lax.psum` / `lax.pmax`."""

    mesh: Any = dataclasses.field(kw_only=True)

    def _over_parts(self, g, reduce: str):
        _record_collective(self, "all-reduce", self._cluster(_nbytes(g)),
                           layer=getattr(self, "_cur_layer", 0))
        if reduce == "max":
            return collectives.pmax(g[0], self.mesh)
        return collectives.psum(g[0], self.mesh)


@dataclasses.dataclass(frozen=True)
class DistHaloSync(_OnRanks, HaloSync):
    """HaloSync on one rank: its [k, B, d] send buffer through one
    all-to-all (the reference's `lax.all_to_all`); a lossy codec's scale
    is gathered from every sender (`lax.all_gather`), so bucket i decodes
    with sender i's scale."""

    mesh: Any = dataclasses.field(kw_only=True)

    def _exchange(self, buf: torch.Tensor) -> torch.Tensor:
        # buf [1, k(bucket), B, d]; result[0, i] = what rank i sent here
        codec = self._codec()
        lay = getattr(self, "_cur_layer", 0)
        payload, meta = codec.encode(buf, layer=lay, stacked=True)
        pb, mb = _nbytes(payload), _nbytes(meta)
        _record_collective(self, "all-to-all", self._cluster(pb),
                           self._cluster(pb + mb), layer=lay)
        recv = collectives.all_to_all(payload[0], self.mesh)
        if meta is not None:
            _record_collective(self, "all-gather",
                               self.mesh.size * self._cluster(mb), layer=lay)
            meta = collectives.all_gather(meta[0], self.mesh)
        return codec.decode(recv, meta)[None]


@dataclasses.dataclass(frozen=True)
class DistRingSync(_OnRanks, RingSync):
    """RingSync on one rank: it holds one payload block at a time, and
    between stages the encoded block (and its scale) moves one rank down
    the ring (the reference's `lax.ppermute` pairs (j, j-1)): k-1 shifts
    an aggregate, the last rotation left out."""

    mesh: Any = dataclasses.field(kw_only=True)

    def _rotate(self, enc, meta):
        return (collectives.ring_shift(enc, self.mesh),
                None if meta is None else collectives.ring_shift(meta,
                                                                 self.mesh))


SYNC_MODES = ("local", "dense", "halo", "ring")


def _unknown(mode: str) -> ValueError:
    return ValueError(f"unknown sync mode {mode!r}: valid strategies are "
                      f"{', '.join(SYNC_MODES)}")


def make_sync(mode: str, blk, codec=None, mesh=None):
    """Instantiate a SyncStrategy: a `Block` for local/dense/halo, a
    `RingBlock` for ring (1.5D layouts have no halo tables). `codec` is a
    name or a `core.wire` Codec (None -> fp32). Without `mesh`, the
    strategies over the stacked partitions (the sim mode); with one (a
    `launch.mesh.Mesh`), the per-rank strategies over this rank's block,
    whose collectives run over the mesh (the dist mode)."""
    codec = as_codec(codec)
    if mode == "local":
        return LocalSync(codec=codec)
    dist = {} if mesh is None else {"mesh": mesh}
    if mode == "dense":
        return (DenseSync if mesh is None else DistDenseSync)(
            blk=blk, codec=codec, **dist)
    if mode == "halo":
        return (HaloSync if mesh is None else DistHaloSync)(
            blk=blk, codec=codec, **dist)
    if mode == "ring":
        if not isinstance(blk, RingBlock):
            raise TypeError(
                "sync mode 'ring' needs a RingBlock (build_ring_blocks over "
                f"a BlockRowBook); got {type(blk).__name__}")
        return (RingSync if mesh is None else DistRingSync)(
            codec=codec, **dist)
    raise _unknown(mode)


def sync_bytes_per_round(book, d: int, mode: str) -> int:
    """Analytic collective volume of ONE complete aggregate, all devices
    (the reference's NumPy accountant, fp32). For halo/dense that is a
    reduce+broadcast pair; for ring the k-1 `ppermute` stages."""
    if mode == "halo":
        # each of k devices sends a [k, B, d] f32 buffer per all_to_all and a
        # reduce+broadcast pair is 2 exchanges: 2·k²·B·d·4 bytes cluster-wide
        return 2 * book.k * book.k * book.bucket * d * 4
    if mode == "dense":
        # psum of [V+1, d] on k devices (ring all-reduce ~ 2x payload)
        return 2 * book.k * (book.num_vertices + 1) * d * 4
    if mode == "ring":
        # k-1 ppermute stages, each device shipping its [Vb+1, d] f32 block
        if not isinstance(book, BlockRowBook):
            raise TypeError("ring volume needs a BlockRowBook")
        return book.k * (book.k - 1) * (book.v_block + 1) * d * 4
    if mode == "local":
        return 0
    raise _unknown(mode)


def ring_bytes_per_round(book: BlockRowBook, d: int) -> int:
    """Cluster-wide `ppermute` bytes of one ring aggregate (k·(k−1)·(Vb+1)·d·4)."""
    return sync_bytes_per_round(book, d, "ring")


def collective_budget(book, d: int, mode: str, codec=None,
                      layer: int = 0) -> dict:
    """The collectives ONE complete aggregate issues across k processes,
    per kind: {kind: {"count": (lo, hi), "cluster_bytes": int}}, as the
    reference predicts them for its compiled program (repro/gnn/sync.py
    `collective_budget`). The stacked partitions issue none; the dist
    mode's ranks issue these (each rank's `Mesh.sent` times k is the
    cluster bytes, tests/test_torch_dist.py).

      halo   2 all_to_alls of each device's [k, B, d] buffer in the codec's
             wire dtype; codecs with a scale gather the k sender scales:
             +2 all-gathers of [k] float32
      ring   k-1 permute stages (payload and scale may be separate
             permutes: [k-1, 2(k-1)] ops), bytes ==
             `sync_wire_bytes_per_round`
      dense  1 all-reduce of the [V+1, d] buffer, float32 for every codec
             (the reduce sums the decoded views)
    """
    codec = as_codec(codec)
    elem = codec.wire_dtype(layer=layer).itemsize
    k = book.k
    if mode == "halo":
        b = book.bucket
        budget = {"all-to-all": {"count": (2, 2),
                                 "cluster_bytes": 2 * k * k * b * d * elem}}
        meta = codec.wire_bytes((k, b, d), layer=layer) - k * b * d * elem
        if meta > 0:
            budget["all-gather"] = {"count": (2, 2),
                                    "cluster_bytes": 2 * k * k * meta}
        return budget
    if mode == "ring":
        if not isinstance(book, BlockRowBook):
            raise TypeError("ring budget needs a BlockRowBook")
        rows = book.v_block + 1
        has_meta = codec.wire_bytes((rows, d), layer=layer) > rows * d * elem
        return {"collective-permute": {
            "count": (k - 1, 2 * (k - 1)) if has_meta else (k - 1, k - 1),
            "cluster_bytes": sync_wire_bytes_per_round(
                book, d, "ring", codec, layer=layer),
        }}
    if mode == "dense":
        return {"all-reduce": {
            "count": (1, 1),
            "cluster_bytes": k * (book.num_vertices + 1) * d * 4,
        }}
    raise ValueError(f"no collective budget for sync mode {mode!r}")


def sync_wire_bytes_per_round(book, d: int, mode: str, codec=None,
                              layer: int = 0) -> int:
    """Codec-aware twin of `sync_bytes_per_round`: the bytes that cross the
    network for ONE complete aggregate, all devices, with each device's
    buffer priced by `codec.wire_bytes` (payload + meta) at aggregate
    ordinal `layer`; the fp32 codec gives `sync_bytes_per_round`."""
    codec = as_codec(codec)

    def wb(shape):
        return codec.wire_bytes(shape, layer=layer)

    if mode == "halo":
        # 2 exchanges per round, each device encoding one [k, B, d] buffer
        return 2 * book.k * wb((book.k, book.bucket, d))
    if mode == "dense":
        # ~2x the encoded [V+1, d] buffer a device (ring all-reduce)
        return 2 * book.k * wb((book.num_vertices + 1, d))
    if mode == "ring":
        if not isinstance(book, BlockRowBook):
            raise TypeError("ring volume needs a BlockRowBook")
        # k-1 stages a device, each shipping one encoded block
        return book.k * (book.k - 1) * wb((book.v_block + 1, d))
    if mode == "local":
        return 0
    raise _unknown(mode)
