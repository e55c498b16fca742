"""GNN models (GraphSAGE / GCN / GAT) as PyTorch functions on stacked blocks.

Twin of repro/gnn/models.py. The reference runs one partition's layer under
`vmap`; here every tensor carries the partitions as a leading dimension:

  x      [k, Vloc+1, F]  local vertex states (last row = dummy/padding sink)
  blk    a `gnn.sync.Block` (or `RingBlock`) of stacked [k, ...] tensors

Every edge aggregation goes through `sync.edge_aggregate(blk, payload,
msg_fn, ...)`, which returns the complete per-destination reduce over the
symmetrised adjacency for all k partitions at once. `msg_fn(src_rows, dst,
mask)` sees the payload rows gathered at each edge's source, the edge's
destination as a row of the flattened [k*(Vloc+1)] row space, and the edge
mask. Self terms (GCN's self-loop, GAT's self-edge) are added after
completion, as in the reference.

`forward` runs the whole model and `loss_fn` is the reference's
master-gated masked cross-entropy over the stacked partitions.

Parameters are a dict {"layers": [dict of tensors]}; `init_params` draws the
same NumPy stream as the reference, so both packages start from
bit-identical weights. The layers also take per-partition parameter copies
(every leaf [k, ...], partition j's copy used on partition j's rows): the
lossy-codec step differentiates each partition's copy in one backward
pass, as the reference's `vmap` gives each lane its own gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = Any


@dataclasses.dataclass(frozen=True)
class GNNSpec:
    model: str = "sage"          # sage | gcn | gat
    feature_dim: int = 64
    hidden_dim: int = 64
    num_classes: int = 16
    num_layers: int = 2
    gat_heads: int = 4
    agg_backend: str = "scatter"  # scatter | tiled | pallas (ops.aggregate)

    def dims(self) -> list[tuple[int, int]]:
        ins = [self.feature_dim] + [self.hidden_dim] * (self.num_layers - 1)
        outs = [self.hidden_dim] * (self.num_layers - 1) + [self.num_classes]
        return list(zip(ins, outs))

    def aggregate_dims(self, mode: str = "halo") -> list[list[int]]:
        """Per layer, the wire width of every `sync.edge_aggregate` the
        layer issues, in issue order. halo/dense/local complete partial
        AGGREGATES: sage/gcn [d_in], gat [H, H, H·dh]; ring rotates the
        PAYLOAD itself: sage/gcn [d_in], gat [H, H+H·dh, H+H·dh] (s_src,
        then the shared [s_src | z] for den and num)."""
        out = []
        for din, dout in self.dims():
            if self.model == "gat":
                h = self.gat_heads
                dh = max(dout // h, 1)
                if mode == "ring":
                    out.append([h, h + h * dh, h + h * dh])
                else:
                    out.append([h, h, h * dh])
            else:
                out.append([din])
        return out


def _glorot(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
    fan_in, fan_out = shape[0], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def init_params_numpy(spec: GNNSpec, seed: int = 0) -> dict:
    """The reference's `init_params` draw (models.py:114-142) as NumPy."""
    rng = np.random.default_rng(seed)
    layers = []
    for din, dout in spec.dims():
        if spec.model == "sage":
            layers.append({
                "w_self": _glorot(rng, (din, dout)),
                "w_neigh": _glorot(rng, (din, dout)),
                "b": np.zeros((dout,), np.float32),
            })
        elif spec.model == "gcn":
            layers.append({
                "w": _glorot(rng, (din, dout)),
                "b": np.zeros((dout,), np.float32),
            })
        elif spec.model == "gat":
            h = spec.gat_heads
            dh = max(dout // h, 1)
            layers.append({
                "w": _glorot(rng, (din, h * dh)),
                "a_src": _glorot(rng, (h, dh)),
                "a_dst": _glorot(rng, (h, dh)),
                "b": np.zeros((h * dh,), np.float32),
                "w_out": (_glorot(rng, (h * dh, dout))
                          if h * dh != dout else np.eye(h * dh, dtype=np.float32)),
            })
        else:
            raise ValueError(f"unknown model {spec.model!r}")
    return {"layers": layers}


def params_from_numpy(tree: dict, device) -> Params:
    """{"layers": [{name: array}]} (NumPy arrays, e.g. the JAX package's
    parameters passed through np.asarray) -> the port's float32 tensors."""
    return {"layers": [
        {name: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
         for name, a in layer.items()}
        for layer in tree["layers"]]}


def init_params(spec: GNNSpec, seed: int = 0, *, device) -> Params:
    return params_from_numpy(init_params_numpy(spec, seed), device)


def per_partition_grads(loss_of, params: Params, *, k: int, stacked: bool):
    """(loss, grads) for the lossy-codec step. `loss_of(live)` runs on fresh
    leaves: with `stacked`, k copies of every leaf ([k, ...]; partition j's
    forward uses copy j), and each copy's gradient is k * dL/dW_j. That is
    the reference's per-lane gradient under `vmap`: every lane's loss is
    the global loss L (a psum), so lane j's gradient is the gradient of the
    k lanes' summed losses with respect to lane j's copy. Unstacked: the
    gradient of `loss_of` itself, dL/dW at k == 1 and k * dL/dW_j on a
    rank of the dist mode (the adjoint of the loss's psum). The loss is
    returned detached."""
    live = {"layers": [
        {name: (t.detach().expand((k,) + t.shape).clone() if stacked
                else t.detach()).requires_grad_()
         for name, t in layer.items()}
        for layer in params["layers"]]}
    loss = loss_of(live)
    flat = [t for layer in live["layers"] for t in layer.values()]
    it = iter(torch.autograd.grad(loss, flat))
    grads = {"layers": [{name: next(it) * k if stacked else next(it)
                         for name in layer} for layer in live["layers"]]}
    return loss.detach(), grads


# ---------------------------------------------------------------------------
# Layers (stacked partitions; `sync` completes aggregates globally)
# ---------------------------------------------------------------------------


def _masked_src(src, dst, mask):
    return src * mask[:, None]


def _rows(b: torch.Tensor) -> torch.Tensor:
    """A bias, shared [d] or per partition [k, d], against [k, n, d] rows."""
    return b if b.dim() == 1 else b[:, None]


def _head_scores(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """[k, n, H] attention scores of z [k, n, H, dh] against a shared
    [H, dh] or per-partition [k, H, dh] vector."""
    return torch.einsum("knhd,hd->knh" if a.dim() == 2 else "knhd,khd->knh",
                        z, a)


def sage_layer(p, x, blk, sync, *, final: bool,
               backend: str = "scatter") -> torch.Tensor:
    agg = sync.edge_aggregate(blk, x, _masked_src, backend=backend)
    mean = agg / torch.clamp(blk.degree, min=1.0)[..., None]
    h = x @ p["w_self"] + mean @ p["w_neigh"] + _rows(p["b"])
    return h if final else F.relu(h)


def gcn_layer(p, x, blk, sync, *, final: bool,
              backend: str = "scatter") -> torch.Tensor:
    dnorm = 1.0 / torch.sqrt(blk.degree + 1.0)  # self-loop-augmented degree
    agg = sync.edge_aggregate(blk, x * dnorm[..., None], _masked_src,
                              backend=backend)
    # self-loop term after completion (replica-consistent, ungated)
    agg = agg + x * (dnorm * dnorm)[..., None]
    h = (agg * dnorm[..., None]) @ p["w"] + _rows(p["b"])
    return h if final else F.relu(h)


def gat_layer(p, x, blk, sync, *, final: bool,
              backend: str = "scatter") -> torch.Tensor:
    k, n = x.shape[:2]
    h_heads, dh = p["a_src"].shape[-2:]
    z = (x @ p["w"]).reshape(k, n, h_heads, dh)
    s_src = _head_scores(z, p["a_src"])  # [k, n, H]
    s_dst = _head_scores(z, p["a_dst"])
    s_dst_rows = s_dst.reshape(k * n, h_heads)

    def score(src_s, dst):
        # attention logit of an edge: src payload rows + the dst row's table
        return F.leaky_relu(src_s + s_dst_rows[dst], 0.2)

    # 1) global max per destination (stable softmax). Rows no valid edge
    # reaches come back at the -1e30 mask floor (scatter) or -inf (tiled
    # drops masked edges); the e_self / -1e29 clamps make the backends agree.
    # Softmax is shift-invariant, so the shift needs no gradient (the
    # reference's stop_gradient): it is taken with no graph, which keeps
    # HaloSync.reduce_max's in-place completion out of autograd.
    e_self = F.leaky_relu(s_src + s_dst, 0.2)
    with torch.no_grad():
        m = sync.edge_aggregate(
            blk, s_src,
            lambda src, dst, mask: torch.where(mask[:, None],
                                               score(src, dst), -1e30),
            reduce="max", backend=backend)
        m_safe = torch.clamp(torch.maximum(m, e_self), min=-1e29)
    m_rows = m_safe.reshape(k * n, h_heads)

    # 2) + 3) share one payload carrying [s_src | z]
    payload = torch.cat([s_src, z.reshape(k, n, h_heads * dh)], dim=2)

    def weight(src, dst, mask):
        return (torch.exp(score(src[:, :h_heads], dst) - m_rows[dst])
                * mask[:, None])

    den = sync.edge_aggregate(blk, payload, weight, backend=backend)
    w_self = torch.exp(e_self - m_safe)
    den = torch.clamp(den + w_self, min=1e-16)

    def weighted_msg(src, dst, mask):
        w = weight(src, dst, mask)
        zf = src[:, h_heads:].reshape(-1, h_heads, dh)
        return (w[:, :, None] * zf).reshape(-1, h_heads * dh)

    num = sync.edge_aggregate(blk, payload, weighted_msg, backend=backend)
    num = num.reshape(k, n, h_heads, dh) + w_self[..., None] * z

    out = (num / den[..., None]).reshape(k, n, h_heads * dh) + _rows(p["b"])
    out = out @ p["w_out"]
    return out if final else F.elu(out)


_LAYERS = {"sage": sage_layer, "gcn": gcn_layer, "gat": gat_layer}


def forward(spec: GNNSpec, params: Params, x, blk, sync) -> torch.Tensor:
    """Full model forward on the stacked blocks. Returns logits
    [k, Vloc+1, num_classes] (valid at every replica; the loss is
    master-gated)."""
    layer_fn = _LAYERS[spec.model]
    n = x.shape[1]
    # the dummy row must stay zero: it is a scatter sink for padding. Out of
    # place (the reference's h.at[-1].set(0.0)): relu / elu save their
    # output for the backward, so an in-place write would break it
    dummy = (torch.arange(n, device=x.device) == n - 1)[:, None]
    # aggregate ordinals restart each forward (VariableRatioCodec ramps on
    # them; a no-op for the fixed-ratio codecs)
    sync.reset_layer_counter()
    h = x
    n_layers = len(params["layers"])
    for li, p in enumerate(params["layers"]):
        h = layer_fn(p, h, blk, sync, final=(li == n_layers - 1),
                     backend=spec.agg_backend)
        h = torch.where(dummy, 0.0, h)
    return h


def loss_fn(spec: GNNSpec, params: Params, x, blk, sync) -> torch.Tensor:
    """Masked softmax cross-entropy, averaged over the global training
    vertices: a scalar. Counted only at master replicas (each training
    vertex once across the cluster); `sync.psum` sums the partitions'
    [local_sum, local_cnt]. The reference's train step averages k equal
    per-device losses; here that mean is this one scalar."""
    logits = forward(spec, params, x, blk, sync)
    logp = F.log_softmax(logits, dim=-1)
    labels = torch.clamp(blk.labels.long(), min=0)
    picked = torch.gather(logp, -1, labels[..., None])[..., 0]
    weight = (blk.train_mask & blk.master & (blk.labels >= 0)).float()
    local_sum = -(picked * weight).sum(dim=1)
    local_cnt = weight.sum(dim=1)
    total = sync.psum(torch.stack([local_sum, local_cnt], dim=1))
    return total[0] / torch.clamp(total[1], min=1.0)
