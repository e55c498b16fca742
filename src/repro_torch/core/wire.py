"""The wire layer: pluggable codecs for every byte-moving path.

Twin of repro/core/wire.py. Partitioning decides how many bytes cross the
network; a codec compresses the same bytes. Every path of the port that
moves bytes routes its payload through one `Codec`:

  gnn/sync.py          halo exchange buffers, the dense sum buffer and the
                       ring's rotating payload (encoded, then decoded
                       before use)
  gnn/feature_store.py remote-miss rows (the DistDGL fetch phase; also the
                       serving embedding stores)
  gnn/fullbatch.py +   the gradient reduce through the error-feedback mean
  gnn/minibatch.py     (`codec_grad_reduce`, composing optim/compress.py)
  core/cost_model.py   analytic wire bytes beside every logical bytes term

A codec is three functions:

  encode(x, *, layer, stacked) -> (payload, meta)  payload crosses the
                                                   wire; meta (the int8
                                                   scale) rides along or
                                                   is None
  decode(payload, meta)        -> x'               float32 reconstruction
  wire_bytes(shape, *, layer)  -> int              payload + meta bytes of
                                                   one encoded tensor

Inputs are NumPy arrays (the host row stores) or torch tensors (the
device). `stacked=True` takes a tensor whose leading dimension holds the k
partitions and encodes each partition with its own scale (one per
reference `vmap` lane), so the meta is [k]; `wire_bytes` stays per
partition, as in the reference. On the host, bf16 payloads are the bf16
bit patterns as `uint16` (`HOST_BF16`: NumPy has no bfloat16), rounded by
torch's cast on the CPU, and the int8 scale is a `np.float32` whatever
NumPy's promotion rules (4 meta bytes, as `wire_bytes` prices them).

`Fp32Codec` is the default and the identity: encode/decode return their
input object untouched, so every default path is bit for bit the
codec-free code.

Gradients through a codec are the reference's: bf16's cast pair rounds the
cotangent to bf16 on the way back; through int8 the gradient reaches the
input only through the scale (the argmax element of |x|), because the
rounding has zero derivative and the int8 cast ends the graph.

Error feedback: `codec_grad_reduce` carries the quantisation residual to
the next step (Seide et al. / Karimireddy et al.), so compression error
acts like a delayed gradient instead of a bias. Lossless codecs take the
plain mean; int8 routes through `optim/compress.py`'s compress /
decompress; other lossy codecs run the same recipe with their own
encode/decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.collectives import pmean_tree
from repro_torch.optim.adam import tree_map
from repro_torch.optim.compress import (
    CompressionState,
    compress,
    compress_init,
    compressed_psum,
    decompress,
    dequantise,
    quantise,
)

__all__ = [
    "CODECS",
    "HOST_BF16",
    "Bf16Codec",
    "Codec",
    "Fp32Codec",
    "Int8EFCodec",
    "VariableRatioCodec",
    "as_codec",
    "codec_grad_reduce",
    "ef_from_numpy",
    "ef_init",
    "make_codec",
    "narrow_wire_dtypes",
    "roundtrip",
]

CODECS = ("fp32", "bf16", "int8", "variable")
# host bf16 payloads: the bf16 bit patterns (NumPy has no bfloat16)
HOST_BF16 = np.dtype(np.uint16)


def _host(x) -> bool:
    return isinstance(x, np.ndarray)


def _nelems(shape) -> int:
    return int(math.prod(int(s) for s in shape))


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(HOST_BF16)


def _bf16_float(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(bits).view(np.int16))
    return t.view(torch.bfloat16).to(torch.float32).numpy()


@runtime_checkable
class Codec(Protocol):
    """What every wire codec implements (see module docstring)."""

    name: str
    lossless: bool

    def encode(self, x, *, layer: int = 0, stacked: bool = False): ...

    def decode(self, payload, meta): ...

    def wire_bytes(self, shape, dtype=np.float32, *, layer: int = 0) -> int: ...

    def wire_dtype(self, layer: int = 0): ...

    def ratio(self, layer: int = 0) -> float: ...


@dataclasses.dataclass(frozen=True)
class Fp32Codec:
    """Identity codec: the wire carries the raw float32 payload. encode /
    decode return their argument unchanged (the same object)."""

    name = "fp32"
    lossless = True

    def encode(self, x, *, layer: int = 0, stacked: bool = False):
        return x, None

    def decode(self, payload, meta):
        return payload

    def wire_bytes(self, shape, dtype=np.float32, *, layer: int = 0) -> int:
        n = _nelems(shape)
        return n * np.dtype(dtype).itemsize if n else 0

    def wire_dtype(self, layer: int = 0):
        return torch.float32

    def ratio(self, layer: int = 0) -> float:
        return 1.0


@dataclasses.dataclass(frozen=True)
class Bf16Codec:
    """Round-to-bfloat16 payload: 2 bytes an element, no meta; relative
    roundtrip error at most 2^-8."""

    name = "bf16"
    lossless = False

    def encode(self, x, *, layer: int = 0, stacked: bool = False):
        if _host(x):
            return _bf16_bits(x), None
        return x.to(torch.bfloat16), None

    def decode(self, payload, meta):
        if _host(payload):
            return _bf16_float(payload)
        return payload.to(torch.float32)

    def wire_bytes(self, shape, dtype=np.float32, *, layer: int = 0) -> int:
        n = _nelems(shape)
        return n * 2 if n else 0

    def wire_dtype(self, layer: int = 0):
        return torch.bfloat16

    def ratio(self, layer: int = 0) -> float:
        return 0.5


@dataclasses.dataclass(frozen=True)
class Int8EFCodec:
    """Per-tensor int8 uniform quantisation (optim/compress.py's scheme):
    scale = max|x| / 127 rides along as one float32 meta scalar per encoded
    tensor (per partition when stacked). The "EF" is the gradient reduce's
    error feedback (`codec_grad_reduce`); activation exchanges encode fresh
    payloads at every sync and carry no state."""

    name = "int8"
    lossless = False
    meta_bytes = 4  # one f32 scale per encoded tensor

    def encode(self, x, *, layer: int = 0, stacked: bool = False):
        if _host(x):
            if stacked:
                raise ValueError("stacked encode takes a torch tensor")
            if x.size == 0:
                return x.astype(np.int8), np.float32(1.0)
            x = x.astype(np.float32)
            # float32 operands throughout: NumPy 1.x would promote a Python
            # float to a float64 scale (8 meta bytes)
            scale = np.float32(np.maximum(np.abs(x).max(), np.float32(1e-12))
                               / np.float32(127.0))
            q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
            return q, scale
        if x.numel() == 0:
            scale = torch.ones(x.shape[:1] if stacked else (),
                               dtype=torch.float32, device=x.device)
            return x.to(torch.int8), scale
        return quantise(x, stacked=stacked)

    def decode(self, payload, meta):
        if _host(payload):
            return payload.astype(np.float32) * meta
        return dequantise(payload, meta)

    def wire_bytes(self, shape, dtype=np.float32, *, layer: int = 0) -> int:
        n = _nelems(shape)
        return n + self.meta_bytes if n else 0

    def wire_dtype(self, layer: int = 0):
        return torch.int8

    def ratio(self, layer: int = 0) -> float:
        return 0.25


@dataclasses.dataclass(frozen=True)
class VariableRatioCodec:
    """The ratio ramps with depth and training progress (SAR's variable
    compression policy). `layer` is the aggregate ordinal within one
    forward pass (GAT's three layer-0 aggregates are ordinals 0..2);
    `epoch < warmup_epochs` softens the schedule one tier:

        layer 0:   int8  (bf16 during warmup)
        layer >=1: bf16  (fp32 during warmup)

    `at_epoch` builds a new codec; decode dispatches on the payload dtype."""

    name = "variable"
    lossless = False
    epoch: int = 0
    warmup_epochs: int = 2

    def _sub(self, layer: int):
        hard = self.epoch >= self.warmup_epochs
        if layer == 0:
            return _INT8 if hard else _BF16
        return _BF16 if hard else _FP32

    def at_epoch(self, epoch: int) -> "VariableRatioCodec":
        return dataclasses.replace(self, epoch=int(epoch))

    def encode(self, x, *, layer: int = 0, stacked: bool = False):
        return self._sub(layer).encode(x, stacked=stacked)

    def decode(self, payload, meta):
        # each sub-codec's payload dtype is its own
        if payload.dtype in (np.int8, torch.int8):
            return _INT8.decode(payload, meta)
        if payload.dtype in (HOST_BF16, torch.bfloat16):
            return _BF16.decode(payload, meta)
        return _FP32.decode(payload, meta)

    def wire_bytes(self, shape, dtype=np.float32, *, layer: int = 0) -> int:
        return self._sub(layer).wire_bytes(shape, dtype)

    def wire_dtype(self, layer: int = 0):
        return self._sub(layer).wire_dtype()

    def ratio(self, layer: int = 0) -> float:
        return self._sub(layer).ratio()


_FP32 = Fp32Codec()
_BF16 = Bf16Codec()
_INT8 = Int8EFCodec()
_REGISTRY = {"fp32": _FP32, "bf16": _BF16, "int8": _INT8,
             "variable": VariableRatioCodec()}


def make_codec(name: str) -> Codec:
    """Codec instance by CLI name (`--codec {fp32,bf16,int8,variable}`)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}: options are {', '.join(CODECS)}")


def as_codec(codec: "Optional[str | Codec]") -> Codec:
    """Normalise None / a name / an instance to a Codec (None -> fp32)."""
    if codec is None:
        return _FP32
    if isinstance(codec, str):
        return make_codec(codec)
    return codec


def roundtrip(codec: Codec, x, *, layer: int = 0, stacked: bool = False):
    """decode(encode(x)): the locally observable effect of the wire."""
    payload, meta = codec.encode(x, layer=layer, stacked=stacked)
    return codec.decode(payload, meta)


def narrow_wire_dtypes(codec: "Optional[str | Codec]",
                       max_layers: int = 4) -> frozenset:
    """Names of the dtypes narrower than float32 this codec may put on the
    wire over its first `max_layers` ordinals ("int8", "bfloat16"); empty
    for fp32."""
    codec = as_codec(codec)
    return frozenset(
        str(dt).removeprefix("torch.")
        for dt in (codec.wire_dtype(layer=layer) for layer in range(max_layers))
        if dt.itemsize < 4)


# ---------------------------------------------------------------------------
# Error-feedback gradient reduction (the trainers' allreduce path)
# ---------------------------------------------------------------------------


def ef_init(grads_like) -> Any:
    """Zero error-feedback accumulator, same tree/shapes as the grads."""
    return compress_init(grads_like).error


def ef_from_numpy(tree, device) -> Any:
    """An EF tree of NumPy (or array-like) leaves, e.g. the JAX package's
    [k, ...] carry through np.asarray, as the port's float32 tensors."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device),
        tree)


def codec_grad_reduce(codec: Codec, grads, ef, *, stacked: bool,
                      mesh=None):
    """Data-parallel gradient mean through the codec, with error feedback.

    `stacked=True`: every leaf holds the k partitions' gradients as its
    leading dimension, and the reduce is their mean (the reference's
    `pmean`: the sum over k, over k); the EF carry is stacked alike.
    `mesh` (launch/mesh.py, the twin of the reference's `axis`): the
    gradients and the carry are this rank's, and the mean runs over the
    ranks. Neither (k == 1): no reduce, but the quantisation and EF still
    apply, as in the reference's `axis=None`. Returns (mean grads without
    the partition dimension, new EF). Lossless codecs leave the EF as it
    is (zero forever)."""
    if stacked and mesh is not None:
        raise ValueError("gradients are stacked or a rank's, not both")

    def mean(tree):
        if mesh is not None:
            return pmean_tree(tree, mesh)
        return tree_map(lambda g: g.sum(0) / g.shape[0] if stacked else g,
                        tree)

    if codec.lossless:
        return mean(grads), ef

    if codec.name == "int8":
        state = CompressionState(error=ef)
        if stacked or mesh is not None:
            reduced, state = compressed_psum(grads, state, mesh=mesh)
            return reduced, state.error
        qs, scales, state = compress(grads, state)
        return decompress(qs, scales), state.error

    def one(g, e):
        corrected = g.to(torch.float32) + e
        deq = roundtrip(codec, corrected, stacked=stacked)
        return deq, corrected - deq

    pairs = tree_map(one, grads, ef)
    return (mean(tree_map(lambda p: p[0], pairs)),
            tree_map(lambda p: p[1], pairs))
