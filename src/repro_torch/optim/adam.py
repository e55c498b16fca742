"""Adam and SGD-momentum as pure functions on parameter trees, plus
global-norm clipping: the twins of repro/optim/adam.py's `adam_init` /
`adam_update`, `sgd_init` / `sgd_update` and `clip_by_global_norm`.

A tree is nested dicts and lists of tensors, as `jax.tree` walks them: the
GNN's `{"layers": [{name: tensor}]}` and an LM's nested dicts alike
(tuples are leaves, so a function may return a tuple per leaf). Leaves go
in the trees' own order: dicts in insertion order, where `jax.tree`
sorts the keys (only the clip's sum of squares, over leaves, can differ
in rounding).

The reference's formulas, kept as they are (not `torch.optim.Adam`, which
puts `eps` elsewhere): bias corrections c1 = 1 - b1**t and c2 = 1 - b2**t
in float32 from an int32 step, then delta = (m / c1) / (sqrt(v / c2) +
eps).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Params = Any


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Params
    nu: Params


def tree_map(fn, *trees) -> Params:
    """Apply `fn` leaf by leaf over trees of the same structure (nested
    dicts and lists; the first tree's keys)."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: tree_map(fn, *(t[key] for t in trees)) for key in first}
    if isinstance(first, list):
        return [tree_map(fn, *items) for items in zip(*trees)]
    return fn(*trees)


def leaves(params: Params) -> list:
    """The leaves of `params` in order (dicts in insertion order)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in leaves(v)]
    if isinstance(params, list):
        return [t for v in params for t in leaves(v)]
    return [params]


def adam_init(params: Params) -> AdamState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    return AdamState(step=step, mu=zeros, nu=tree_map(torch.zeros_like, zeros))


@torch.no_grad()
def adam_update(
    grads: Params,
    state: AdamState,
    params: Params,
    *,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[Params, AdamState]:
    """One Adam step: (new params, new state); the inputs are not
    modified. The reference's weight decay is left out: no path uses it."""
    step = state.step + 1
    # float32 tensors, as the reference's `b1 ** t` on a float32 step (a
    # Python float power would be float64)
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m = b1 * m + (1.0 - b1) * g32
        v = b2 * v + (1.0 - b2) * torch.square(g32)
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        return p - lr * delta.to(p.dtype), m, v

    out = tree_map(upd, grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), AdamState(step=step, mu=pick(1), nu=pick(2))


def adam_step(
    loss_of: Callable[[Params], torch.Tensor],
    params: Params,
    state: AdamState,
    *,
    lr: float,
) -> tuple[torch.Tensor, Params, AdamState]:
    """One training step: `loss_of` on fresh leaf copies of `params`, their
    gradients by one autograd pass, and one `adam_update`. Returns (the
    loss before the update, detached; new params; new state)."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_of(live)
    it = iter(torch.autograd.grad(loss, leaves(live)))
    grads = tree_map(lambda _: next(it), live)
    new_params, new_state = adam_update(grads, state, params, lr=lr)
    return loss.detach(), new_params, new_state


class SGDState(NamedTuple):
    velocity: Params


def sgd_init(params: Params) -> SGDState:
    return SGDState(velocity=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


@torch.no_grad()
def sgd_update(
    grads: Params,
    state: SGDState,
    params: Params,
    *,
    lr: float = 1e-2,
    momentum: float = 0.9,
) -> tuple[Params, SGDState]:
    """One SGD-momentum step: v = momentum * v + g (float32), p - lr * v;
    the inputs are not modified."""
    def upd(g, v, p):
        v = momentum * v + g.to(torch.float32)
        return p - lr * v.to(p.dtype), v

    out = tree_map(upd, grads, state.velocity, params)
    return (tree_map(lambda o: o[0], out),
            SGDState(velocity=tree_map(lambda o: o[1], out)))


@torch.no_grad()
def clip_by_global_norm(grads: Params,
                        max_norm: float) -> tuple[Params, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / max(norm, 1e-12)), norm
    the float32 square root of the summed squares over all leaves (summed
    leaf by leaf, in order); returns (clipped grads in their dtypes,
    norm)."""
    sq = None
    for g in leaves(grads):
        term = torch.sum(torch.square(g.to(torch.float32)))
        sq = term if sq is None else sq + term
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm
