"""Public wrappers for the kernels, with device dispatch.

Twin of repro/kernels/ops.py (segment_spmm, aggregate, flash_attention,
decode_attention). On a CUDA tensor the tiled path and the attention ops
launch the hand-written kernels (kernels/segment_spmm.py,
flash_attention.py, decode_attention.py); on a CPU tensor they compute the
same function in plain PyTorch. "pallas", the reference's name for "force
the kernel", keeps that meaning here (the aggregate backend, the attention
ops' `use_pallas=True`), so one `GNNSpec` runs in both packages: it
launches the kernel and raises on a CPU tensor.

`aggregate` is differentiable on every backend. On the tiled and pallas
backends two `torch.autograd.Function`s (`_TiledSum`, `_TiledMax`), twins
of the reference's `custom_vjp`s, wrap the layout gather and the segment
reduce on both devices: the kernel on CUDA, its plain version on the CPU,
so the CPU tests run the backward the card runs. The sum's backward is the
gather `g[dst]`; the max's is the masked argmax, with ties split evenly
and counted by the same segment sum. Neither saves the `[E_tiled, F]`
gathered layout. With no graph to record (serving, under
`inference_mode`) `aggregate` runs the same forward without them. The
kernel wrapper itself stays forward only.

`flash_attention` is differentiable too: when a gradient is wanted it goes
through `_FlashAttention`, the twin of the reference's custom VJP
(`_flash_core` in repro/models/layers.py), which keeps only q, k, v, out
and the rows' log-sum-exp and runs the backward kernel (CUDA) or its
plain version (CPU). Without one it calls the forward alone.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import segment_spmm as _spmm
from repro_torch.kernels.tiling import DEFAULT_BLOCK_E, DEFAULT_TILE_V, tiled_shape

AGG_BACKENDS = ("scatter", "tiled", "pallas")
AGG_REDUCES = ("sum", "max")

# The aten ops that accumulate data-dependently, which the no-scatter rule
# hunts for in recorded programs (analysis/dispatch.py names them
# "<namespace>.<op>"; an `index_put` with accumulate=True is recorded as
# "<op>:accumulate"). A plain `index_put_` is an `.at[].set`, which the
# reference does not count either. On the card these ops add in atomic
# order, so no kernel path may issue one.
SCATTER_PRIMITIVES = (
    "aten.index_add", "aten.index_add_",
    "aten.scatter_add", "aten.scatter_add_",
    "aten.scatter_reduce", "aten.scatter_reduce_",
    "aten.index_reduce", "aten.index_reduce_",
    "aten.index_put:accumulate", "aten.index_put_:accumulate",
    "aten._index_put_impl_:accumulate",
)


def scatter_free_traced(backend: str, device) -> bool:
    """Whether `aggregate(backend=...)` runs WITHOUT data-dependent
    accumulating ops on `device`; the twin of the reference's predicate,
    from which the no-scatter rule derives each program's expectation.

    "pallas" always launches the kernel (and raises on a CPU tensor), so
    it is scatter-free wherever it runs. "tiled" launches the kernel on a
    CUDA tensor, while a CPU tensor takes the plain version, whose
    `index_add_` (`ref.segment_sum_ref`) is a scatter: the reference's
    tiled backend falls back the same way off the TPU. "scatter" is the
    oracle by definition."""
    if backend == "pallas":
        return True
    return backend == "tiled" and torch.device(device).type == "cuda"


def segment_spmm(
    messages: torch.Tensor,
    local_dst: torch.Tensor,
    num_rows: int,
    *,
    combiner: str = "sum",
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
) -> torch.Tensor:
    """Tiled segment reduce (`combiner` in {"sum", "max"}) over a
    `prepare_tiled_edges` layout built with the same (tile_v, block_e).
    `num_rows` may be unpadded: the grid comes from `tiled_shape` and the
    result is [num_rows, F]. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    e = messages.shape[0]
    rows_padded, n_tiles = tiled_shape(num_rows, tile_v)
    assert e % n_tiles == 0, (
        f"tiled layout mismatch: {e} edges do not split over {n_tiles} row "
        f"tiles (num_rows={num_rows}, tile_v={tile_v}); was the layout built "
        f"with a different (num_rows, tile_v)?")
    return _reduce(messages, local_dst, rows_padded, combiner, tile_v,
                   block_e)[:num_rows]


def _reduce(messages, local_dst, rows_padded: int, combiner: str,
            tile_v: int, block_e: int) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU one:
    [rows_padded, F], a fresh tensor (no view: autograd forbids in-place
    writes on a view that a custom Function returns)."""
    if messages.is_cuda:
        return _spmm.segment_spmm(messages, local_dst, rows_padded,
                                  combiner=combiner, tile_v=tile_v,
                                  block_e=block_e)
    # the plain version's rows are a view of its sink-row buffer
    return _spmm.segment_spmm_plain(messages, local_dst, rows_padded,
                                    combiner=combiner, tile_v=tile_v).clone()


def _tiled_reduce(messages, edge_order, local_dst, num_rows: int,
                  reduce: str, tile_v: int, block_e: int) -> torch.Tensor:
    """Gather `messages` into the tiled layout (the pad slot reads a row of
    the reduce identity) and segment-reduce: [rows_padded, F], fresh."""
    rows_padded, _ = tiled_shape(num_rows, tile_v)
    fill = 0.0 if reduce == "sum" else float("-inf")
    msg_pad = torch.cat(
        [messages, messages.new_full((1, messages.shape[1]), fill)])
    return _reduce(msg_pad.index_select(0, edge_order), local_dst,
                   rows_padded, reduce, tile_v, block_e)


def _gather_rows(g: torch.Tensor, dst: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """g[min(dst, num_rows)] with a zero pad row: the transpose of a
    segment sum into rows dst (sink dst == num_rows gets nothing)."""
    g_pad = torch.cat([g[:num_rows], g.new_zeros((1, g.shape[1]))])
    return g_pad.index_select(0, torch.clamp(dst.long(), max=num_rows))


class _TiledSum(torch.autograd.Function):
    """Tiled segment sum of `messages` into [rows_padded, F] rows; the
    twin of the reference's `_tiled_aggregate`. Backward: the transpose of
    a pre-sorted scatter-add is a gather, grad_messages = g[dst]."""

    @staticmethod
    def forward(ctx, messages, dst, edge_order, local_dst, num_rows, tile_v,
                block_e):
        ctx.save_for_backward(dst)
        ctx.num_rows = num_rows
        return _tiled_reduce(messages, edge_order, local_dst, num_rows,
                             "sum", tile_v, block_e)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return (_gather_rows(g, dst, ctx.num_rows),
                None, None, None, None, None, None)


class _TiledMax(torch.autograd.Function):
    """Tiled segment max (init -inf); the twin of the reference's
    `_tiled_aggregate_max`. Backward: the cotangent of row r flows to the
    layout-present edges whose message equals the row max (exact: the
    kernel takes maxes without arithmetic), split evenly among ties, the
    scatter oracle's convention. An edge the layout dropped is not part of
    the computed max and gets zero even where it ties. Ties are counted by
    the same segment sum as the forward (the kernel on CUDA). The GAT
    layers take their softmax shift with no gradient and never run this;
    it serves a standalone `aggregate(reduce="max")`. It saves its output,
    so that output must not be written in place before the backward."""

    @staticmethod
    def forward(ctx, messages, dst, edge_order, local_dst, num_rows, tile_v,
                block_e):
        out = _tiled_reduce(messages, edge_order, local_dst, num_rows, "max",
                            tile_v, block_e)
        ctx.save_for_backward(messages, dst, out, edge_order, local_dst)
        ctx.args = (num_rows, tile_v, block_e)
        return out

    @staticmethod
    def backward(ctx, g):
        messages, dst, out, edge_order, local_dst = ctx.saved_tensors
        num_rows, tile_v, block_e = ctx.args
        e, f = messages.shape
        dstc = torch.clamp(dst.long(), max=num_rows)
        # pad slots of the layout index row e, one past the messages
        in_layout = torch.zeros(e + 1, dtype=torch.bool,
                                device=messages.device)
        in_layout[edge_order] = True
        # the sink row compares against +inf (never the max)
        out_pad = torch.cat([out[:num_rows], out.new_full((1, f), math.inf)])
        is_max = ((messages == out_pad.index_select(0, dstc))
                  & in_layout[:e, None])
        ties = _tiled_reduce(is_max.to(g.dtype), edge_order, local_dst,
                             num_rows, "sum", tile_v, block_e)
        share = (_gather_rows(g, dstc, num_rows)
                 / torch.clamp(_gather_rows(ties, dstc, num_rows), min=1.0))
        grad = torch.where(is_max, share, 0.0).to(messages.dtype)
        return grad, None, None, None, None, None, None


def aggregate(
    messages: torch.Tensor,   # [E, F] per-edge messages (original edge order)
    dst: torch.Tensor,        # [E] destination row per edge (<= num_rows)
    num_rows: int,
    *,
    edge_order: torch.Tensor | None = None,  # int64, from prepare_tiled_edges
    local_dst: torch.Tensor | None = None,   # int32
    backend: str = "scatter",
    reduce: str = "sum",
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
) -> torch.Tensor:
    """Segment-reduce `messages` into `[num_rows, F]` vertex rows.

    backend:
      scatter — index_add_ / scatter_reduce_(amax) on the original edge
                order, any device, autograd's own backward; dst == num_rows
                is a sink row
      tiled   — gather into the `prepare_tiled_edges` layout, then the
                kernel (CUDA tensors) or its plain version (CPU tensors);
                the `_TiledSum` / `_TiledMax` backward
      pallas  — like tiled but always the kernel: raises on CPU tensors

    reduce: sum (identity 0) or max (identity -inf: rows no edge reaches
    come back as -inf; the tiled layout drops `valid`-masked edges, so
    callers clamp against a finite floor, as the GAT layers do).
    """
    if reduce not in AGG_REDUCES:
        raise ValueError(f"unknown aggregate reduce {reduce!r}; "
                         f"options: {AGG_REDUCES}")
    if backend == "scatter":
        idx = torch.clamp(dst.long(), max=num_rows)
        if reduce == "max":
            return ref.segment_max_ref(messages, idx, num_rows)
        return ref.segment_sum_ref(messages, idx, num_rows)
    if backend not in AGG_BACKENDS:
        raise ValueError(f"unknown aggregate backend {backend!r}; "
                         f"options: {AGG_BACKENDS}")
    assert edge_order is not None and local_dst is not None, (
        "tiled/pallas backends need the prepare_tiled_edges layout")
    if edge_order.shape[-1] == 0 and messages.shape[0] > 0:
        raise ValueError(
            "empty tiled layout: the partition book / sample plan was built "
            "without tiled_layout=True but a tiled backend was requested")
    if backend == "pallas" and not messages.is_cuda:
        raise ValueError("backend 'pallas' forces the CUDA kernel; got a "
                         f"tensor on {messages.device}")
    if torch.is_grad_enabled() and messages.requires_grad:
        fn = _TiledMax if reduce == "max" else _TiledSum
        out = fn.apply(messages, dst, edge_order, local_dst, num_rows,
                       tile_v, block_e)
    else:
        # no graph to record: the same forward without the Function, whose
        # own host time is a tenth of a served GAT batch's host compute
        # (median 0.083 of 0.73 ms, each batch timed both ways on an H100;
        # chip_smoke.py --aggregate-host)
        out = _tiled_reduce(messages, edge_order, local_dst, num_rows,
                            reduce, tile_v, block_e)
    return out[:num_rows]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _use_kernel(x: torch.Tensor, use_pallas: bool | None) -> bool:
    """None: the kernel for a CUDA tensor, the plain version for a CPU one.
    True forces the kernel (raises on a CPU tensor); False the plain one."""
    if use_pallas is None:
        return x.is_cuda
    if use_pallas and not x.is_cuda:
        raise ValueError("use_pallas=True forces the CUDA kernel; got a "
                         f"tensor on {x.device}")
    return bool(use_pallas)


class _FlashAttention(torch.autograd.Function):
    """Flash attention on folded [BH, S, D] tensors with the reference's
    backward: the forward saves q, k, v, out and the fp32 log-sum-exp
    [BH, Sq]; the backward recomputes the probabilities from them under
    the same mask (`causal`, `window`) (`flash_attention_bwd`: the kernels
    on CUDA with `kernel`, else the plain versions) and returns dq, dk, dv
    in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, kernel: bool):
        fn = (_flash.flash_attention if kernel
              else _flash.flash_attention_plain)
        out, lse = fn(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.kernel = causal, window, kernel
        return out

    @staticmethod
    def backward(ctx, dout):
        fn = (_flash.flash_attention_bwd if ctx.kernel
              else _flash.flash_attention_bwd_plain)
        dq, dk, dv = fn(*ctx.saved_tensors, dout, causal=ctx.causal,
                        window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Attention, [B, H, Sq, D] in q's dtype. A causal call needs Sq ==
    Skv (raises ValueError otherwise, on both paths) and may take a band
    `window` W > 0 (keeps 0 <= q_idx - k_idx < W; 0: none). Differentiable:
    with a gradient wanted the call goes through `_FlashAttention`, whose
    backward takes the same route as the forward (the kernel or the plain
    version)."""
    b, h, sq, d = q.shape
    kernel = _use_kernel(q, use_pallas)
    fold = lambda x: x.reshape(b * h, x.shape[2], d)  # noqa: E731
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _FlashAttention.apply(fold(q), fold(k), fold(v), causal,
                                    window, kernel)
    else:
        fn = (_flash.flash_attention if kernel
              else _flash.flash_attention_plain)
        out = fn(fold(q), fold(k), fold(v), causal=causal, window=window)
    return out.reshape(b, h, sq, d)


def decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,
    valid_len,        # int or 0-d integer tensor
    *,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """One query row per (batch, head) against the cache, [B, H, D]; cache
    slots >= valid_len are masked out."""
    b, h, s, d = k.shape
    fn = (_decode.decode_attention if _use_kernel(q, use_pallas)
          else _decode.decode_attention_plain)
    return fn(q.reshape(b * h, d), k.reshape(b * h, s, d),
              v.reshape(b * h, s, d), valid_len).reshape(b, h, d)
