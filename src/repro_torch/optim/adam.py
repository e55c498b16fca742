"""Adam as a pure function on the `{"layers": [{name: tensor}]}` parameter
dict, the twin of repro/optim/adam.py's `adam_init` / `adam_update`.

The reference's formula, kept as it is (not `torch.optim.Adam`, which puts
`eps` elsewhere): bias corrections c1 = 1 - b1**t and c2 = 1 - b2**t in
float32 from an int32 step, then delta = (m / c1) / (sqrt(v / c2) + eps).
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
    """Apply `fn` leaf by leaf over `{"layers": [{name: tensor}]}` trees of
    the same structure."""
    return {"layers": [
        {name: fn(*(t["layers"][li][name] for t in trees)) for name in layer}
        for li, layer in enumerate(trees[0]["layers"])]}


def leaves(params: Params) -> list:
    """The tensors of `params`, layer by layer in name order."""
    return [t for layer in params["layers"] for t in layer.values()]


def adam_init(params: Params) -> AdamState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = next(iter(params["layers"][0].values())).device
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
    live = {"layers": [
        {name: t.detach().requires_grad_() for name, t in layer.items()}
        for layer in params["layers"]]}
    loss = loss_of(live)
    it = iter(torch.autograd.grad(loss, leaves(live)))
    grads = {"layers": [{name: next(it) for name in layer}
                        for layer in live["layers"]]}
    new_params, new_state = adam_update(grads, state, params, lr=lr)
    return loss.detach(), new_params, new_state
