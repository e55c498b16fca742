"""Synchronisation strategies for distributed full-graph GNN layers.

Twin of repro/gnn/sync.py (Local and Halo; Dense and Ring come later). The
reference runs one partition per `vmap` lane; here the k partitions are a
leading dimension of every tensor, so a collective is a tensor op over that
dimension:

    edge_aggregate(blk, payload [k, n, d], msg_fn, *, reduce, backend)
        -> [k, n, d], complete over the symmetrised adjacency
    psum(v [k, ...]) -> [...], the sum over the partitions (the
        reference's `lax.psum` over its device axis)

`msg_fn(src_rows, dst_rows, edge_mask)` sees the payload rows gathered at
each edge's source, the edge's destination as a row of the flattened
[k*n] row space (for destination-side tables such as GAT's softmax shift)
and the edge mask; n = v_max + 1 (the last row of each partition is the
dummy/padding sink).

All k partitions aggregate in ONE `ops.aggregate` call. For the tiled
backends that works because every partition's layout has the same
`per_tile`: stacked, the k layouts are one layout over k * rows_padded rows
(`local_dst` is tile-relative), so one kernel launch serves them all.

  LocalSync — k=1: the partial aggregates are already complete.
  HaloSync  — static-routed replica completion from the partition book's
              replica lists. The reference's `lax.all_to_all(split_axis=0,
              concat_axis=0)` over the stacked [k(sender), k(bucket), B, d]
              buffer is `send.transpose(0, 1)`; its `.at[].add/max/set`
              are index_add_ / scatter_reduce_("amax") / index assignment on the
              flattened [k*n] rows. These update the fresh aggregate in
              place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.partition_book import EdgePartitionBook
from repro_torch.kernels import ops
from repro_torch.kernels.tiling import tiled_shape


class Block(NamedTuple):
    """The k partitions' static device state, stacked [k, ...].

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


def build_blocks(
    book: EdgePartitionBook,
    features: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    *,
    device: torch.device,
) -> Block:
    """Stacked Block on `device` from a partition book + global node data."""
    k, n = book.k, book.v_max + 1
    x = book.local_features(features.astype(np.float32))
    lab = book.local_labels(labels.astype(np.int32))
    tm = np.zeros((k, n), dtype=bool)
    safe = np.where(book.vglobal >= 0, book.vglobal, 0)
    tm[:] = train_mask[safe]
    tm &= book.vmask
    vg = np.where(book.vglobal >= 0, book.vglobal, book.num_vertices)

    rows_padded, _ = tiled_shape(n)
    e2 = 2 * book.e_max
    part = np.arange(k, dtype=np.int64)[:, None]
    src2 = np.concatenate([book.esrc, book.edst], axis=1).astype(np.int64)
    dst2 = np.concatenate([book.edst, book.esrc], axis=1).astype(np.int64)
    mask2 = np.concatenate([book.emask, book.emask], axis=1)
    order = book.agg_order.astype(np.int64)
    order = np.where(order == e2, k * e2, part * e2 + order)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return Block(
        x=t(x), labels=t(lab), train_mask=t(tm),
        esrc=t(book.esrc, torch.int64), edst=t(book.edst, torch.int64),
        emask=t(book.emask), degree=t(book.degree), master=t(book.master),
        vmask=t(book.vmask),
        send_idx=t(book.send_idx, torch.int64), send_mask=t(book.send_mask),
        recv_idx=t(book.recv_idx, torch.int64), recv_mask=t(book.recv_mask),
        vglobal=t(vg, torch.int64),
        sym_src=t((part * n + src2).reshape(-1)),
        sym_dst=t((part * n + dst2).reshape(-1)),
        sym_mask=t(mask2.reshape(-1)),
        agg_dst=t((part * rows_padded + dst2).reshape(-1)),
        agg_order=t(order.reshape(-1)),
        agg_ldst=t(book.agg_ldst.reshape(-1), torch.int32),
        rows_padded=rows_padded,
    )


class _PartialAggSync:
    """Shared `edge_aggregate` for the partial-aggregate family: reduce the
    messages over every partition's symmetrised local edge list, then
    complete the partials with the strategy's reduce + broadcast pair."""

    def edge_aggregate(self, blk: Block, payload: torch.Tensor, msg_fn, *,
                       reduce: str = "sum", backend: str = "scatter"):
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
    """k=1: partial aggregates are already complete."""

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
class HaloSync(_PartialAggSync):
    """Static-routed replica synchronisation (the paper-faithful path).

    reduce_*: every mirror packs its partial rows for each master partition
    into fixed buckets; after the exchange, masters scatter-accumulate.
    broadcast: the exact reverse routing pushes completed rows back."""

    blk: Block

    @staticmethod
    def _exchange(buf: torch.Tensor) -> torch.Tensor:
        # buf [k(sender), k(bucket), B, d]; result[j, i] = what i sent to j
        return buf.transpose(0, 1)

    def _gather(self, h, idx):
        k, n, d = h.shape
        return h.reshape(k * n, d)[_flat_rows(idx, n)].reshape(idx.shape + (d,))

    def reduce_sum(self, h):
        blk = self.blk
        k, n, d = h.shape
        send = self._gather(h, blk.send_idx) * blk.send_mask[..., None]
        recv = self._exchange(send)
        # pads point at the dummy row and carry zeros -> harmless adds
        flat = h.reshape(k * n, d)
        flat.index_add_(0, _flat_rows(blk.recv_idx, n), recv.reshape(-1, d))
        return flat.reshape(k, n, d)

    def reduce_max(self, h):
        blk = self.blk
        k, n, d = h.shape
        send = torch.where(blk.send_mask[..., None],
                           self._gather(h, blk.send_idx), -1e30)
        recv = self._exchange(send)
        recv = torch.where(blk.recv_mask[..., None], recv, -1e30)
        flat = h.reshape(k * n, d)
        idx = _flat_rows(blk.recv_idx, n)[:, None].expand(-1, d)
        flat.scatter_reduce_(0, idx, recv.reshape(-1, d), reduce="amax",
                             include_self=True)
        return flat.reshape(k, n, d)

    def broadcast(self, h):
        blk = self.blk
        k, n, d = h.shape
        send = self._gather(h, blk.recv_idx) * blk.recv_mask[..., None]
        recv = self._exchange(send)
        current = self._gather(h, blk.send_idx)
        updated = torch.where(blk.send_mask[..., None], recv, current)
        # real send slots are unique; pad slots all rewrite the dummy row
        # with its own value
        flat = h.reshape(k * n, d)
        flat[_flat_rows(blk.send_idx, n)] = updated.reshape(-1, d)
        return flat.reshape(k, n, d)

    def psum(self, v):
        return v.sum(0)


SYNC_MODES = ("local", "halo")


def make_sync(mode: str, blk: Block):
    """Instantiate a SyncStrategy over the stacked `blk`."""
    if mode == "local":
        return LocalSync()
    if mode == "halo":
        return HaloSync(blk=blk)
    raise ValueError(
        f"unknown sync mode {mode!r}: this port has {', '.join(SYNC_MODES)}")


def sync_bytes_per_round(book, d: int, mode: str) -> int:
    """Analytic collective volume of ONE complete aggregate, all devices
    (the reference's NumPy accountant for the modes this port has)."""
    if mode == "halo":
        # each of k devices sends a [k, B, d] f32 buffer per all_to_all and a
        # reduce+broadcast pair is 2 exchanges: 2·k²·B·d·4 bytes cluster-wide
        return 2 * book.k * book.k * book.bucket * d * 4
    if mode == "local":
        return 0
    raise ValueError(
        f"unknown sync mode {mode!r}: this port has {', '.join(SYNC_MODES)}")
