"""Distributed full-batch GNN training (vertex-cut halo/dense + 1.5D ring).

Twin of repro/gnn/fullbatch.py in both of its multi-partition modes. The
per-partition program (models.py + sync.py) is the same in each:

  mode="sim"   the reference's `jax.vmap` over the stacked [k, ...]
               blocks: every tensor carries the k partitions as its
               leading dimension (gnn/sync.py), a collective is a tensor
               op over it, and autograd through the stack stands in for
               the vmap backward. One process, one device.
  mode="dist"  the reference's `jax.shard_map` over a real mesh axis
               (`wrap_spmd`, `FullBatchTrainer.mode`): one process a
               partition, each a rank of a `torch.distributed` group
               (launch/mesh.py; launch/ranks.py spawns them). A rank holds
               its own block (the sim's tables and padding, its slice) and
               its collectives run over the group (core/collectives.py).

The step is composed from the reference's stage functions:

  build_book          partition layout     (edge book | 1.5D block rows)
  build_device_blocks static device state  (`Block` | `RingBlock`, stacked,
                                            or one rank's)
  make_step_fns       loss / forward closed over the SyncStrategy

`FullBatchTrainer` composes them and trains with the reference's Adam
(optim/adam.py), under local, dense, halo or ring sync and any wire codec
(core/wire.py). The fp32 codec (the default) takes the lossless step:
one gradient of the loss through shared leaves, bit for bit the codec-free
step. A lossy codec takes the reference's error-feedback step: each
partition's gradient k * dL/dW_j through per-partition parameter copies
(`models.per_partition_grads`), their compressed mean with the EF carry
(`codec_grad_reduce`), then Adam on the mean. Either step runs under
PyTorch's deterministic algorithms (`minibatch.repeatable_step`), as the
mini-batch step does, so it repeats bit for bit on the CPU and on the
card, scatter backend included.

In the dist mode every rank computes the global loss L (the loss's
`sync.psum` is an all-reduce), so the adjoint of that psum hands each
rank k times its share: rank j's backward gives k * dL/dW_j, the sim's
per-partition gradient. The lossless step takes their mean over the ranks
(one all-reduce), which is dL/dW, the sim step's gradient; the lossy step
feeds them to the EF reduce over the group, each rank with its own carry.
Every rank then takes the same Adam step on the same mean.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core.graph import Graph
from repro_torch.core.partition_book import (
    BlockRowBook,
    build_blockrow_book,
    build_edge_book,
)
from repro_torch.core.wire import as_codec, codec_grad_reduce, ef_init
from repro_torch.gnn import models
from repro_torch.gnn.minibatch import repeatable_step
from repro_torch.gnn.models import GNNSpec
from repro_torch.gnn.sync import (
    SYNC_MODES,
    build_blocks,
    build_ring_blocks,
    make_sync,
    sync_bytes_per_round,
    sync_wire_bytes_per_round,
)
from repro_torch.obs.trace import get_tracer
from repro_torch.optim import (
    AdamState,
    adam_init,
    adam_step,
    adam_update,
    leaves,
    tree_map,
)

MODES = ("sim", "dist")


def build_book(
    graph: Graph,
    edge_assignment: Optional[np.ndarray],
    k: int,
    *,
    sync_mode: str = "halo",
    tiled_layout: bool = False,
):
    """The static layout for a sync strategy: halo/dense/local run on an
    `EdgePartitionBook` (any edge partitioner); ring runs on a
    `BlockRowBook` (1.5D contiguous blocks: `edge_assignment` is ignored
    and may be None)."""
    if sync_mode not in SYNC_MODES:
        raise ValueError(f"unknown sync mode {sync_mode!r}: valid strategies "
                         f"are {', '.join(SYNC_MODES)}")
    if sync_mode == "ring":
        return build_blockrow_book(graph, k, tiled_layout=tiled_layout)
    if edge_assignment is None:
        raise ValueError(f"sync mode {sync_mode!r} needs an edge assignment")
    return build_edge_book(graph, edge_assignment, k,
                           tiled_layout=tiled_layout)


def build_device_blocks(book, features, labels, train_mask, *, device,
                        part: Optional[int] = None):
    """Device blocks matching the book's layout: the k partitions stacked
    [k, ...], or with `part` that partition alone (a stack of one)."""
    build = build_ring_blocks if isinstance(book, BlockRowBook) else \
        build_blocks
    return build(book, features, labels, train_mask, device=device,
                 part=part)


def resolve_sync_mode(sync_mode: str, k: int) -> str:
    """k=1 collapses the partial-aggregate strategies to the LocalSync
    oracle. Ring stays ring: its blocks carry chunk tables, not halo
    tables, and its k=1 loop is one stage."""
    if k == 1 and sync_mode != "ring":
        return "local"
    return sync_mode


def make_step_fns(spec: GNNSpec, sync_mode: str, k: int, codec=None,
                  mesh=None):
    """(loss_fn, forward_fn), each `(params, blk) -> ...` over the stacked
    partitions, or with `mesh` over this rank's block: the loss a scalar
    (the global loss, on every rank), the logits [k, n, C] ([1, n, C] on
    a rank)."""
    mode = resolve_sync_mode(sync_mode, k)

    def loss(params, blk):
        return models.loss_fn(spec, params, blk.x, blk,
                              make_sync(mode, blk, codec=codec, mesh=mesh))

    def forward(params, blk):
        return models.forward(spec, params, blk.x, blk,
                              make_sync(mode, blk, codec=codec, mesh=mesh))

    return loss, forward


@dataclasses.dataclass
class FullBatchTrainer:
    spec: GNNSpec
    book: Any                          # EdgePartitionBook | BlockRowBook
    blocks: Any                        # Block | RingBlock: stacked, or a rank's
    sync_mode: str = "halo"            # local | dense | halo | ring
    params: Any = None
    opt_state: Optional[AdamState] = None
    lr: float = 1e-2
    codec: Any = None                  # wire codec name/instance (None=fp32)
    ef_state: Any = None               # error-feedback carry (lossy codecs)
    mode: str = "sim"                  # sim (vmap) | dist (shard_map)
    mesh: Any = None                   # launch.mesh.Mesh of the dist mode

    @classmethod
    def build(
        cls,
        graph: Graph,
        edge_assignment: Optional[np.ndarray],
        k: int,
        spec: GNNSpec,
        features: np.ndarray,
        labels: np.ndarray,
        train_mask: np.ndarray,
        *,
        sync_mode: str = "halo",
        mode: str = "sim",
        mesh=None,
        seed: int = 0,
        lr: float = 1e-2,
        codec=None,
        device: Optional[torch.device] = None,
    ) -> "FullBatchTrainer":
        """Partition layout, device blocks and parameters. `mode="dist"`
        runs in each of k ranks with this rank's `mesh` (launch/mesh.py)
        and builds this rank's block on `mesh.device`; every rank must
        pass the same arguments. `from_book` takes a layout already built
        (by a parent process, once for all ranks)."""
        book = build_book(
            graph, edge_assignment, k, sync_mode=sync_mode,
            tiled_layout=(spec.agg_backend != "scatter"),
        )
        return cls.from_book(book, spec, features, labels, train_mask,
                             sync_mode=sync_mode, mode=mode, mesh=mesh,
                             seed=seed, lr=lr, codec=codec, device=device)

    @classmethod
    def from_book(cls, book, spec: GNNSpec, features: np.ndarray,
                  labels: np.ndarray, train_mask: np.ndarray, *,
                  sync_mode: str = "halo", mode: str = "sim", mesh=None,
                  seed: int = 0, lr: float = 1e-2, codec=None,
                  device: Optional[torch.device] = None
                  ) -> "FullBatchTrainer":
        """The trainer over a built `book` (see `build`)."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; options: {MODES}")
        part = None
        if mode == "dist":
            if mesh is None or mesh.size != book.k:
                raise ValueError(
                    f"mode 'dist' runs one rank a partition: a mesh of "
                    f"{book.k} ranks, got "
                    f"{'none' if mesh is None else mesh.size}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"rank {mesh.rank} runs on {mesh.device}, "
                                 f"not {device}")
            device, part = mesh.device, mesh.rank
        elif mesh is not None:
            raise ValueError("a mesh belongs to mode 'dist'")
        if device is None:
            raise ValueError("the sim mode needs a device")
        blocks = build_device_blocks(book, features, labels, train_mask,
                                     device=device, part=part)
        params = models.init_params(spec, seed=seed, device=device)
        return cls(spec=spec, book=book, blocks=blocks, sync_mode=sync_mode,
                   params=params, opt_state=adam_init(params), lr=lr,
                   codec=codec, mode=mode, mesh=mesh)

    @functools.cached_property
    def _step_fns(self):
        return make_step_fns(self.spec, self.sync_mode, self.book.k,
                             codec=self.codec, mesh=self.mesh)

    def _init_ef(self):
        """Per-partition zero EF residuals, stacked [k, ...] like the
        blocks; no leading k at k == 1 (the reference's carry) or on a
        rank (its own carry)."""
        k = self.book.k
        if k == 1 or self.mesh is not None:
            return ef_init(self.params)
        return ef_init(tree_map(lambda p: p.expand((k,) + p.shape),
                                self.params))

    def train_step(self) -> float:
        """One Adam step on the full graph; returns the loss before the
        update. Reading it waits for the whole step, update included (one
        stream). The step runs under `minibatch.repeatable_step`, so it
        repeats bit for bit on every backend and device (a resumed run is
        the uninterrupted one's); under an installed tracer it is the
        `fullbatch.step` span, which ends after that read."""
        tracer = get_tracer()
        span = (tracer.span("fullbatch.step", cat="step",
                            args={"sync": self.sync_mode})
                if tracer.enabled else contextlib.nullcontext())
        with span, repeatable_step():
            return self._step()

    def _step(self) -> float:
        """The step's body, outside the deterministic mode (`train_step`
        runs it inside; the smoke times the two against each other)."""
        loss_of, _ = self._step_fns
        codec = as_codec(self.codec)
        if codec.lossless and self.mesh is None:
            loss, self.params, self.opt_state = adam_step(
                lambda params: loss_of(params, self.blocks), self.params,
                self.opt_state, lr=self.lr)
            return float(loss)
        k = self.book.k
        stacked = k > 1 and self.mesh is None
        if self.ef_state is None and not codec.lossless:
            self.ef_state = self._init_ef()
        loss, grads = models.per_partition_grads(
            lambda params: loss_of(params, self.blocks), self.params, k=k,
            stacked=stacked)
        mean, self.ef_state = codec_grad_reduce(codec, grads, self.ef_state,
                                                stacked=stacked,
                                                mesh=self.mesh)
        self.params, self.opt_state = adam_update(
            mean, self.opt_state, self.params, lr=self.lr)
        return float(loss)

    def set_epoch(self, epoch: int) -> None:
        """Advance an epoch-scheduled codec (VariableRatioCodec); the step
        functions, which close over the codec, are rebuilt."""
        advance = getattr(as_codec(self.codec), "at_epoch", None)
        if advance is not None:
            self.codec = advance(epoch)
            self.__dict__.pop("_step_fns", None)

    def forward_logits(self) -> torch.Tensor:
        """The forward pass's logits, [k, n, C] stacked ([1, n, C] on a
        rank), with no graph."""
        _, forward = self._step_fns
        with torch.no_grad():
            return forward(self.params, self.blocks)

    def forward_logits_global(self) -> np.ndarray:
        """Master-row logits gathered to a global [V, C] array (testing);
        in the dist mode every rank gathers the ranks' blocks first."""
        out = self.forward_logits()
        if self.mesh is not None:
            with torch.no_grad():
                out = collectives.all_gather(out[0], self.mesh)
        return self.book.scatter_to_global(out.cpu().numpy())

    # ------------------------------------------------------------- accounting
    def comm_bytes_per_epoch(self) -> int:
        """Analytic collective traffic of one full-batch epoch (fwd+bwd).

        Backward of a reduce+broadcast pair is another broadcast+reduce
        pair; backward of a ppermute ring is the reverse ring: either way
        2x the forward volume. GAT syncs 3 aggregates/layer, SAGE/GCN
        1; each aggregate is priced at its true payload width
        (`GNNSpec.aggregate_dims`).
        """
        total = 0
        for layer_dims in self.spec.aggregate_dims(self.sync_mode):
            for d in layer_dims:
                per = sync_bytes_per_round(self.book, d, self.sync_mode)
                total += per * 2  # fwd + bwd
        # gradient all-reduce of the (replicated) model parameters
        n_params = sum(int(np.prod(p.shape)) for p in leaves(self.params))
        total += 2 * self.book.k * n_params * 4
        return total

    def wire_bytes_per_epoch(self) -> int:
        """Codec-aware twin of `comm_bytes_per_epoch`: the bytes that cross
        the network once payloads are encoded (== the logical number under
        fp32), each aggregate at its ordinal."""
        codec = as_codec(self.codec)
        total = 0
        ordinal = 0
        for layer_dims in self.spec.aggregate_dims(self.sync_mode):
            for d in layer_dims:
                per = sync_wire_bytes_per_round(
                    self.book, d, self.sync_mode, codec, layer=ordinal)
                total += per * 2  # fwd + bwd
                ordinal += 1
        # gradient all-reduce, priced per leaf (per-tensor codec meta)
        leaf_bytes = sum(codec.wire_bytes(p.shape) for p in leaves(self.params))
        total += 2 * self.book.k * leaf_bytes
        return total

    def memory_bytes_per_partition(self) -> np.ndarray:
        """Analytic per-partition training memory (features + activations +
        graph structure), the quantity behind the paper's Fig. 10/11."""
        k = self.book.k
        f = self.spec.feature_dim
        h = self.spec.hidden_dim
        L = self.spec.num_layers
        verts = self.book.vmask.sum(axis=1)  # true local vertices
        if isinstance(self.book, BlockRowBook):
            edges = self.book.chunk_emask.sum(axis=(1, 2))
            # double-buffered rotation payload instead of halo buckets
            comm_buf = 2 * (self.book.v_block + 1) * max(f, h) * 4
        else:
            edges = self.book.emask.sum(axis=1)
            comm_buf = 2 * k * self.book.bucket * max(f, h) * 4
        feat = verts * f * 4
        # stored activations: one [Vloc, hidden] per layer (backward needs them)
        acts = verts * h * 4 * L
        structure = edges * 2 * 4
        return (feat + acts + structure + comm_buf).astype(np.int64)
