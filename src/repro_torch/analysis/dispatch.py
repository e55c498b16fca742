"""Recorded-op analysis: the static half of the invariant rules.

The counterpart of repro/analysis/jaxpr.py. The reference walks the jaxpr
`jax.jit` would compile; eager PyTorch compiles nothing, so the port
records what a call dispatches instead. `OpRecorder` is a
`TorchDispatchMode`: it sees every aten op below autograd, inside
`autograd.Function.forward` and every sub-call alike, so there is no
sub-program to recurse into (no `iter_eqns`). Each op is kept as its name,
its input and output dtypes and, for a dtype-changing copy, the cast's
(source, destination) pair; values are never read, so recording neither
synchronises the card nor changes a result.

The hand kernels are bound through ctypes, below the dispatcher. Their
wrappers count launches (`LAUNCHES` of kernels/segment_spmm.py,
flash_attention.py, decode_attention.py); the recorder appends one
`kernel:<library>` entry for each launch the call made.

Names are "<namespace>.<op>" ("aten.index_add_"); an `index_put` with
accumulate=True, an accumulating scatter where the plain one is an
`.at[].set`, is named "<namespace>.<op>:accumulate".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "Op",
    "OpRecorder",
    "convert_ops",
    "count_primitives",
    "narrowing_converts",
    "primitive_names",
    "record",
]

# ops whose output is their input in another dtype: (source arg, dest arg;
# None: the output)
_CASTS = {"aten._to_copy": (0, None), "aten.to": (0, None),
          "aten.copy_": (1, 0)}
# index_put and its in-place forms: `accumulate` is their fourth argument
_INDEX_PUTS = ("aten.index_put", "aten.index_put_", "aten._index_put_impl_")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _dtypes(values) -> tuple:
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(_dtype_name(v.dtype))
        elif isinstance(v, (list, tuple)):
            out.extend(_dtypes(v))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched op (or one hand-kernel launch)."""

    name: str                         # "aten.index_add_", "kernel:<lib>"
    in_dtypes: tuple = ()
    out_dtypes: tuple = ()
    cast: Optional[tuple] = None      # (src, dst) of a dtype-changing copy


def _op(func, args, kwargs, out) -> Op:
    name = f"{func.namespace}.{func.overloadpacket.__name__}"
    cast = None
    if name in _CASTS:
        src_i, dst_i = _CASTS[name]
        src = args[src_i].dtype
        dst = (args[dst_i] if dst_i is not None else out).dtype
        if src != dst:
            cast = (_dtype_name(src), _dtype_name(dst))
    elif name in _INDEX_PUTS:
        if kwargs.get("accumulate", len(args) > 3 and args[3]):
            name += ":accumulate"
    outs = out if isinstance(out, (list, tuple)) else (out,)
    return Op(name=name, in_dtypes=_dtypes(list(args) + list(kwargs.values())),
              out_dtypes=_dtypes(outs), cast=cast)


def _launch_totals() -> dict:
    """{library name: launches so far} over the three hand kernels."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import segment_spmm

    return {m.LIBRARY.name: sum(m.LAUNCHES.values())
            for m in (segment_spmm, flash_attention, decode_attention)}


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched inside the `with` block into `ops`; on
    exit, one `kernel:<library>` entry a hand-kernel launch the block made
    (the launch counters' delta, so launch order against the aten ops is
    not kept). Recording is per thread, as dispatch modes are."""

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self._launches: dict = {}

    def __enter__(self):
        self._launches = _launch_totals()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for name, n in _launch_totals().items():
            self.ops.extend(Op(name=f"kernel:{name}")
                            for _ in range(n - self._launches.get(name, 0)))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append(_op(func, args, kwargs, out))
        return out


def record(fn, *args, **kw) -> list:
    """The ops `fn(*args, **kw)` dispatched, in order, then its kernel
    launches (see `OpRecorder`)."""
    with OpRecorder() as rec:
        fn(*args, **kw)
    return rec.ops


def primitive_names(ops) -> set:
    """Every op name in a recorded program."""
    return {op.name for op in ops}


def count_primitives(ops) -> dict:
    """{op name: occurrence count} over a recorded program."""
    counts: dict = {}
    for op in ops:
        counts[op.name] = counts.get(op.name, 0) + 1
    return counts


def convert_ops(ops) -> dict:
    """{(src_dtype_name, dst_dtype_name): count} of every dtype-changing
    copy (`_to_copy` / `to` / `copy_`). A `view(dtype)` is a bitcast, not
    a convert, as `bitcast_convert_type` is not `convert_element_type`."""
    out: dict = {}
    for op in ops:
        if op.cast is not None:
            out[op.cast] = out.get(op.cast, 0) + 1
    return out


def narrowing_converts(ops) -> dict:
    """Converts that SHRINK a floating payload: {(src, dst): count} where
    src is a float dtype of >= 4 bytes and dst is strictly smaller (bf16,
    f16, int8, fp8, ...). Integer index-width churn (i64 -> i32) and
    widenings (bool -> f32) are not wire compression and are ignored."""
    out: dict = {}
    for (src, dst), n in convert_ops(ops).items():
        sdt, ddt = getattr(torch, src), getattr(torch, dst)
        if (sdt.is_floating_point and sdt.itemsize >= 4
                and ddt.itemsize < sdt.itemsize):
            out[(src, dst)] = out.get((src, dst), 0) + n
    return out
