"""The MFG forward of DistDGL-style mini-batch GNNs (serving's recompute).

Twin of the device half of repro/gnn/minibatch.py (`_mb_aggregate`,
`_mb_{sage,gcn,gat}_layer`, `mfg_forward`); training comes later. `lay` is a
dict of tensors (esrc, edst, emask, deg, and for the tiled backends
agg_order / agg_ldst); `n_dst` is static from the pad plan. Aggregation
targets are sized n_dst+1; index n_dst is the padding sink. Pad edges'
`esrc` must be clamped to the last source row, as JAX's gather clamps
(serve/engine.py does so when it stages a batch); their messages are
masked to zero.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.gnn.models import GNNSpec
from repro_torch.kernels import ops


def _mb_aggregate(messages, lay, n_dst: int, backend: str,
                  reduce: str = "sum"):
    """Reduce per-edge messages into the [n_dst+1, d] destination rows."""
    return ops.aggregate(
        messages, lay["edst"], n_dst + 1,
        edge_order=lay.get("agg_order"), local_dst=lay.get("agg_ldst"),
        backend=backend, reduce=reduce,
    )


def _mb_sage_layer(p, h_src, lay, n_dst: int, *, final: bool,
                   backend: str = "scatter"):
    msg = h_src[lay["esrc"]] * lay["emask"][:, None]
    agg = _mb_aggregate(msg, lay, n_dst, backend)
    mean = agg[:-1] / torch.clamp(lay["deg"][:-1], min=1.0)[:, None]
    h_self = h_src[:n_dst]
    out = h_self @ p["w_self"] + mean @ p["w_neigh"] + p["b"]
    return out if final else F.relu(out)


def _mb_gcn_layer(p, h_src, lay, n_dst: int, *, final: bool,
                  backend: str = "scatter"):
    deg_dst = lay["deg"][:-1] + 1.0
    msg = h_src[lay["esrc"]] * lay["emask"][:, None]
    agg = _mb_aggregate(msg, lay, n_dst, backend)
    h = (agg[:-1] + h_src[:n_dst]) / deg_dst[:, None]
    out = h @ p["w"] + p["b"]
    return out if final else F.relu(out)


def _mb_gat_layer(p, h_src, lay, n_dst: int, *, final: bool,
                  backend: str = "scatter"):
    heads, dh = p["a_src"].shape
    z = (h_src @ p["w"]).reshape(h_src.shape[0], heads, dh)
    s_src = torch.einsum("nhd,hd->nh", z, p["a_src"])
    s_dst = torch.einsum("nhd,hd->nh", z[:n_dst], p["a_dst"])
    s_dst_pad = F.pad(s_dst, (0, 0, 0, 1))
    e = F.leaky_relu(s_src[lay["esrc"]] + s_dst_pad[lay["edst"]], 0.2)
    e = torch.where(lay["emask"][:, None], e, -1e30)
    e_self = F.leaky_relu(s_src[:n_dst] + s_dst, 0.2)

    # softmax stabilisation max through the same segment reduce as the sums,
    # with no gradient (the reference's stop_gradient; exact, softmax is
    # shift-invariant)
    with torch.no_grad():
        m = _mb_aggregate(e, lay, n_dst, backend, reduce="max")
        m = torch.maximum(m[:-1], e_self)
    m_pad = F.pad(m, (0, 0, 0, 1))
    w = torch.exp(e - m_pad[lay["edst"]]) * lay["emask"][:, None]
    w_self = torch.exp(e_self - m)
    den = _mb_aggregate(w, lay, n_dst, backend)
    den = den[:-1] + w_self
    num = _mb_aggregate(
        (w[:, :, None] * z[lay["esrc"]]).reshape(-1, heads * dh),
        lay, n_dst, backend,
    ).reshape(n_dst + 1, heads, dh)
    num = num[:-1] + w_self[:, :, None] * z[:n_dst]
    out = (num / torch.clamp(den, min=1e-16)[:, :, None]).reshape(n_dst, heads * dh)
    out = (out + p["b"]) @ p["w_out"]
    return out if final else F.elu(out)


_MB_LAYERS = {"sage": _mb_sage_layer, "gcn": _mb_gcn_layer, "gat": _mb_gat_layer}


def mfg_forward(spec: GNNSpec, layer_params: Sequence, batch,
                layer_sizes: Sequence[int]) -> torch.Tensor:
    """Forward one padded MFG stack through `layer_params`, which may be a
    suffix of the model's layers (serving recomputes only the last `hops`
    layers, so `batch["x"]` is then embedding rows). The stack always ends
    at the model's final layer, so the last entry has no activation."""
    h = batch["x"]
    layer_fn = _MB_LAYERS[spec.model]
    L = len(layer_params)
    for li, p in enumerate(layer_params):
        h = layer_fn(p, h, batch["layers"][li], layer_sizes[li],
                     final=(li == L - 1), backend=spec.agg_backend)
    return h
