"""The port's selective remat policy (`lm.set_remat_policy`) against the
JAX package's, on the CPU.

The reference stores a policy name, tags the SSM in-projection with
`checkpoint_name(proj, "ssm_proj")` and runs each block under
`jax.checkpoint(policy=save_only_these_names(name))`: the backward's
recompute keeps that product and skips its matmul. The port tags the same
product (`lm._tagged`) and runs each block under a selective checkpoint
whose policy keeps the tagged `mm`.

Tolerances (each test states its own):
  - the policy against no policy and against no remat: bit for bit, every
    arch, fp32 and bf16 (the policy changes memory and recompute, not
    values);
  - the port under the policy against `jax.grad` of the reference's
    `loss_fn(remat=True)` under its own policy, fp32: each leaf's largest
    |port - ref| at most (F32_GRAD_NOISE x the reference's conditioning +
    F32_GRAD_FLOOR) of the leaf's largest |value|, the loss within 2e-5
    (tests/test_torch_lm_train.py's `test_loss_gradients_match_jax_fp32`);
  - the backward's `aten.mm` count: exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

ARCHS = tbase.ARCH_IDS
SSM_ARCHS = ("mamba2-370m", "hymba-1.5b")
POLICY = "ssm_proj"
UNTAGGED = "attn_out"  # a name no product carries
B, S = 2, 32
# tests/test_torch_lm_train.py's fp32 gradient bound
F32_GRAD_NOISE = 4.0
F32_GRAD_FLOOR = 2e-5


@pytest.fixture(autouse=True)
def no_policy_after():
    """Both packages' policies back to None after each test: a policy left
    set would reach later tests on the same worker."""
    yield
    lm.set_remat_policy(None)
    jlm.set_remat_policy(None)


def _leaves(prefix, tree) -> dict:
    """{prefix/path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(f"{prefix}/{k}", v))
        return out
    return {prefix: tree}


def _config(arch, dtype):
    return dataclasses.replace(tbase.smoke_config(arch), dtype=dtype)


def _batch(cfg, seed=0) -> dict:
    """Tokens [B, S] with the family's extras (whisper's frames, the VLM's
    patch embeddings and M-RoPE positions), drawn with NumPy from `seed`."""
    rng = np.random.default_rng(seed)
    dt = lm._dtype(cfg)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))}
    if cfg.encoder_decoder:
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(dt)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)).to(dt)
        total = cfg.num_patches + S
        batch["pos3"] = torch.arange(total).expand(3, B, total).contiguous()
    return batch


class _CountMM(TorchDispatchMode):
    """Counts the `aten.mm` calls dispatched under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _grads(cfg, params, batch, *, policy, remat=True):
    """(loss, {path: gradient}, the backward's mm count) of the port's
    `loss_fn` under `policy`; weights that take no part get zeros."""
    lm.set_remat_policy(policy)
    live = optim.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(cfg, live, batch, remat=remat)
    count = _CountMM()
    with count:
        grads = torch.autograd.grad(loss, optim.leaves(live),
                                    materialize_grads=True)
    lm.set_remat_policy(None)
    it = iter(grads)
    return (loss.detach(), _leaves("", optim.tree_map(lambda _: next(it),
                                                      live)), count.mm)


def _init(cfg, seed=0):
    return lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _same(a, b, what):
    assert torch.equal(a[0], b[0]), f"{what}: loss {a[0]} != {b[0]}"
    assert set(a[1]) == set(b[1])
    for name, g in a[1].items():
        assert torch.equal(g, b[1][name]), f"{what}: {name}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_gradients_equal_no_policy_and_no_remat_bitwise(arch, dtype):
    """Every arch's loss and every gradient under "ssm_proj" are those
    under None and under `remat=False`, bit for bit. The eight archs
    without an SSM carry no tagged product: the mark and the selective
    checkpoint change nothing there."""
    cfg = _config(arch, dtype)
    params, batch = _init(cfg), _batch(cfg)
    kept = _grads(cfg, params, batch, policy=POLICY)
    full = _grads(cfg, params, batch, policy=None)
    none = _grads(cfg, params, batch, policy=None, remat=False)
    _same(kept, full, f"{arch} {dtype} policy vs None")
    _same(kept, none, f"{arch} {dtype} policy vs no remat")


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_saves_one_mm_a_ssm_block(arch):
    """The backward under "ssm_proj" dispatches one `aten.mm` fewer per
    SSM block than under None (its recompute reuses the in-projection);
    a name nothing carries, and every arch without an SSM, give None's
    count."""
    cfg = _config(arch, "float32")
    params, batch = _init(cfg), _batch(cfg)
    n_full = _grads(cfg, params, batch, policy=None)[2]
    n_kept = _grads(cfg, params, batch, policy=POLICY)[2]
    n_untagged = _grads(cfg, params, batch, policy=UNTAGGED)[2]
    ssm_blocks = cfg.num_layers if cfg.ssm else 0
    assert n_full - n_kept == ssm_blocks, (n_full, n_kept)
    assert n_untagged == n_full, (n_untagged, n_full)
    if arch == "mamba2-370m":
        assert ssm_blocks == 3
    if arch == "hymba-1.5b":
        assert ssm_blocks == 4  # 2 global + 2 windowed, each with its SSM


def test_hook_stores_any_name_and_none_restores_the_plain_path(
        monkeypatch):
    """`set_remat_policy` stores any name, as the reference's does, and
    None brings back the plain checkpoint (no selective context)."""
    calls = []
    real = lm.create_selective_checkpoint_contexts

    def spy(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(lm, "create_selective_checkpoint_contexts", spy)
    cfg = _config("mamba2-370m", "float32")
    params, batch = _init(cfg), _batch(cfg)
    for name in (POLICY, UNTAGGED, None):
        lm.set_remat_policy(name)
        assert lm._REMAT_POLICY == name
        calls.clear()
        lm.loss_fn(cfg, optim.tree_map(
            lambda t: t.detach().requires_grad_(), params), batch)
        assert len(calls) == (0 if name is None else cfg.num_layers)


def test_kernel_route_recomputes_the_flash_forward_under_the_policy(
        monkeypatch):
    """hymba on the flash route as on the card (the route sees "cuda", the
    kernel wrappers stand in as counting plain versions behind
    `ops._FlashAttention`): under "ssm_proj" every attention layer's flash
    forward runs again in the recompute, as under None; the same launches
    and the same gradients bit for bit."""
    fwd_calls, bwd_calls = [], []
    real_route = layers.attention_route
    plain_fwd = flash.flash_attention_plain
    plain_bwd = flash.flash_attention_bwd_plain

    def route(*args, device="cuda", **kw):
        return real_route(*args, device="cuda", **kw)

    def fwd(q, k, v, *, causal, window=0, return_lse=False):
        fwd_calls.append(tuple(q.shape))
        return plain_fwd(q, k, v, causal=causal, window=window,
                         return_lse=return_lse)

    def bwd(*args, causal, window=0):
        bwd_calls.append(tuple(args[0].shape))
        return plain_bwd(*args, causal=causal, window=window)

    monkeypatch.setattr(layers, "attention_route", route)
    monkeypatch.setattr(ops, "_use_kernel", lambda x, use_pallas: True)
    monkeypatch.setattr(flash, "flash_attention", fwd)
    monkeypatch.setattr(flash, "flash_attention_bwd", bwd)
    # head dim 64 (a kernel's), the window the sequence: flash takes every
    # attention layer, global and windowed
    cfg = dataclasses.replace(_config("hymba-1.5b", "bfloat16"),
                              head_dim=64, sliding_window=S)
    params, batch = _init(cfg), _batch(cfg)
    got = {}
    for policy in (None, POLICY):
        fwd_calls.clear()
        bwd_calls.clear()
        got[policy] = _grads(cfg, params, batch, policy=policy)
        n = cfg.num_layers
        assert len(fwd_calls) == 2 * n and len(bwd_calls) == n, (
            policy, fwd_calls, bwd_calls)
    _same(got[POLICY], got[None], "hymba kernel route, policy vs None")
    assert got[None][2] - got[POLICY][2] == cfg.num_layers


def _one_ulp(tree, seed):
    """Every float32 weight moved by one ulp, up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        to = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
        return jnp.asarray(np.nextafter(a, to.astype(np.float32)))

    return jax.tree.map(move, tree)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_policy_gradients_match_the_reference_policy_fp32(arch):
    """fp32: the port's loss and gradients under "ssm_proj" against
    `jax.grad` of the reference's `loss_fn(remat=True)` under its own
    "ssm_proj" policy (traced after the policy is set: the reference reads
    it at trace time), the weights carried across; each leaf within
    (F32_GRAD_NOISE x the reference's conditioning + F32_GRAD_FLOOR) of
    its scale, the conditioning measured on this function."""
    jc = dataclasses.replace(jbase.smoke_config(arch), dtype="float32")
    cfg = _config(arch, "float32")
    jparams = jax.jit(lambda key: jlm.init_params(jc, key))(
        jax.random.PRNGKey(7))
    batch = _batch(cfg, seed=len(arch))
    jb = {"tokens": jnp.asarray(batch["tokens"].numpy().astype(np.int32))}
    jlm.set_remat_policy(POLICY)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jc, p, b, remat=True)))
    want_loss, want = vg(jparams, jb)
    want = {k: np.asarray(v, np.float32)
            for k, v in _leaves("", want).items()}
    cond = 0.0
    for seed in (5, 6):
        _, moved = vg(_one_ulp(jparams, seed), jb)
        for k, v in _leaves("", moved).items():
            scale = max(float(np.abs(want[k]).max()), 1e-30)
            cond = max(cond, float(np.abs(np.asarray(v) - want[k]).max())
                       / scale)
    params = lm.params_from_reference(jax.tree.map(np.asarray, jparams))
    loss, got, _ = _grads(cfg, params, batch, policy=POLICY)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5)
    rel = F32_GRAD_NOISE * cond + F32_GRAD_FLOOR
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        bound = rel * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{arch} {name}: {err:.3g} > {bound:.3g}"
