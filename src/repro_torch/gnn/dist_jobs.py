"""What each rank of a dist-mode launch runs: jobs over this rank's mesh.

    results = ranks.run_ranks(dist_jobs.run_jobs, k, backend="gloo",
                              device="cuda", args=(jobs,))

`run_jobs(mesh, jobs)` runs a list of `(name, kwargs)` jobs in order on
every rank and returns their results, NumPy and plain Python only, so the
parent (a test, the smoke) builds the layouts once, launches the ranks
once, and holds what comes back:

  train       a `FullBatchTrainer` in mode "dist" from the parent's book:
              the losses, final parameters and EF carry, and per step its
              wall, the host seconds staging and inside the collectives,
              the bytes handed to them and the segment-reduce launches;
              `runs` runs it again from scratch (the bitwise repeat).
              The first run also gives the logits before and after (rank
              0), a forward's bytes and (with `grads`) the first step's
              gradient
  aggregate   one `edge_aggregate` of a random payload, with no graph: its
              bytes and calls by collective kind (the HLO byte pins' twins)
  segment     `ops.aggregate` on this rank's slice of stacked messages
  ef_reduce   `codec_grad_reduce` over the mesh, step by step, on this
              rank's slice of stacked gradients

Every job ends with the ranks in step: each issues the same collectives
in the same order, since their blocks share one set of shapes.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.core.partition_book import BlockRowBook
from repro_torch.core.wire import as_codec, codec_grad_reduce, ef_init
from repro_torch.gnn.fullbatch import (
    FullBatchTrainer,
    build_device_blocks,
    resolve_sync_mode,
)
from repro_torch.gnn import models
from repro_torch.gnn.sync import make_sync
from repro_torch.kernels import ops
from repro_torch.kernels import segment_spmm as spmm
from repro_torch.optim import tree_map


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _first_grads(tr: FullBatchTrainer):
    """The gradient the trainer's next step takes: lossless, the mean of
    the ranks' k * dL/dW_j (dL/dW); lossy, this rank's k * dL/dW_j."""
    loss_of, _ = tr._step_fns
    _, grads = models.per_partition_grads(
        lambda p: loss_of(p, tr.blocks), tr.params, k=tr.book.k,
        stacked=False)
    codec = as_codec(tr.codec)
    if codec.lossless:
        grads, _ = codec_grad_reduce(codec, grads, None, stacked=False,
                                     mesh=tr.mesh)
    return _np(grads)


def train(mesh, *, book, spec, features, labels, train_mask,
          sync_mode="halo", steps=1, codec=None, seed=0, lr=1e-2,
          runs=1, grads=False) -> dict:
    """`runs` fresh dist trainers of `steps` steps each (see the module
    docstring). Logits come back from rank 0 only; the rest from every
    rank."""
    out = {"runs": [], "jax_loaded": "jax" in sys.modules}
    for i in range(runs):
        tr = FullBatchTrainer.from_book(
            book, spec, features, labels, train_mask, sync_mode=sync_mode,
            mode="dist", mesh=mesh, seed=seed, lr=lr, codec=codec)
        run = {}
        if i == 0:  # a repeat's forwards would give the same bits
            run["logits_before"] = tr.forward_logits_global()
            mesh.reset_counters()
            tr.forward_logits()
            run["forward_sent"] = dict(mesh.sent)
            if grads:
                run["grads"] = _first_grads(tr)
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(mesh.device)
        losses, walls, stage, coll, sent = [], [], [], [], []
        spmm.LAUNCHES.clear()
        for _ in range(steps):
            mesh.reset_counters()
            _sync(mesh)
            t0 = time.perf_counter()
            losses.append(tr.train_step())
            walls.append(time.perf_counter() - t0)
            stage.append(mesh.stage_seconds)
            coll.append(mesh.collective_seconds)
            sent.append(dict(mesh.sent))
        run.update(
            losses=losses, step_seconds=walls, stage_seconds=stage,
            collective_seconds=coll, step_sent=sent,
            launches=dict(spmm.LAUNCHES),
            peak_bytes=(torch.cuda.max_memory_allocated(mesh.device)
                        if mesh.device.type == "cuda" else 0),
            params=_np(tr.params),
            ef_state=None if tr.ef_state is None else _np(tr.ef_state))
        if i == 0:
            run["logits_after"] = tr.forward_logits_global()
            if mesh.rank:
                del run["logits_before"], run["logits_after"]
        out["runs"].append(run)
        del tr
    return out


def aggregate(mesh, *, book, sync_mode, d, codec=None, seed=0) -> dict:
    """One `edge_aggregate` (the sum, scatter backend) of a random [n, d]
    payload on this rank's block, with no graph: the bytes and calls it
    handed to torch.distributed, by kind."""
    n_rows = (book.v_block if isinstance(book, BlockRowBook)
              else book.v_max) + 1
    feats = np.zeros((book.num_vertices, 1), np.float32)
    zeros = np.zeros(book.num_vertices, np.int32)
    blk = build_device_blocks(book, feats, zeros, zeros.astype(bool),
                              device=mesh.device, part=mesh.rank)
    payload = torch.as_tensor(
        np.random.default_rng([seed, mesh.rank]).normal(
            size=(1, n_rows, d)).astype(np.float32), device=mesh.device)
    mode = resolve_sync_mode(sync_mode, book.k)
    sync = make_sync(mode, blk, codec=codec, mesh=mesh)
    mesh.reset_counters()
    with torch.no_grad():
        sync.edge_aggregate(blk, payload,
                            lambda src, dst, mask: src * mask[:, None])
    return {"sent": dict(mesh.sent), "calls": dict(mesh.calls)}


def segment(mesh, *, messages, dst, order, ldst, rows, reduce="max",
            backend="tiled") -> np.ndarray:
    """`ops.aggregate` of this rank's slice of stacked [k, ...] inputs."""
    r = mesh.rank
    dev = mesh.device
    out = ops.aggregate(
        torch.as_tensor(messages[r], device=dev),
        torch.as_tensor(dst[r], dtype=torch.int64, device=dev), rows,
        edge_order=torch.as_tensor(order[r], dtype=torch.int64, device=dev),
        local_dst=torch.as_tensor(ldst[r], dtype=torch.int32, device=dev),
        backend=backend, reduce=reduce)
    return out.cpu().numpy()


def ef_reduce(mesh, *, seq, codec) -> list:
    """`codec_grad_reduce` over the mesh on this rank's slice of each
    stacked gradient tree of `seq`, the EF carry from zero: per step the
    (mean, this rank's carry)."""
    codec = as_codec(codec)
    dev = mesh.device

    def mine(tree):
        return tree_map(lambda a: torch.as_tensor(a[mesh.rank], device=dev),
                        tree)

    ef = ef_init(mine(seq[0]))
    out = []
    for g in seq:
        mean, ef = codec_grad_reduce(codec, mine(g), ef, stacked=False,
                                     mesh=mesh)
        out.append((_np(mean), _np(ef)))
    return out


JOBS = {"train": train, "aggregate": aggregate, "segment": segment,
        "ef_reduce": ef_reduce}


def run_jobs(mesh, jobs) -> list:
    """The results of `jobs` ([(name, kwargs)], names of `JOBS`), in
    order, with this rank's launch and byte counters."""
    return [JOBS[name](mesh, **kwargs) for name, kwargs in jobs]

