"""The port's segment reduce against the JAX package's, on the CPU.

A CPU tensor takes the kernel's plain PyTorch version, so here the port's
`segment_spmm` / `aggregate` are held against `repro.kernels.ops` on two
JAX paths: the jnp oracle (`use_pallas=False`) and the Pallas kernel body
in interpret mode (`interpret=True`). The shapes are those of
tests/test_kernels.py; the tolerances are its own (fp32 sum rtol 1e-5 /
atol 8e-5, fp32 max 1e-6). The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against the same plain version there).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_spmm as spmm  # noqa: E402

JAX_PATHS = [{"use_pallas": False}, {"interpret": True}]
TOL = {"sum": (1e-5, 8e-5), "max": (1e-6, 8e-6)}
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py as a module (it imports only numpy at its top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _layout(e, v, f, combiner, seed, **tiling):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, v, e).astype(np.int32)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    order, local_dst, rows_p = jops.prepare_tiled_edges(dst, v, **tiling)
    fill = 0.0 if combiner == "sum" else -np.inf
    msgs_pad = np.concatenate([msgs, np.full((1, f), fill, np.float32)])[order]
    return dst, msgs, msgs_pad, local_dst, rows_p


def _check(msgs_pad, local_dst, num_rows, combiner, **tiling):
    """Port plain path == both JAX paths, on the same NumPy inputs."""
    out = ops.segment_spmm(torch.as_tensor(msgs_pad),
                           torch.as_tensor(local_dst), num_rows,
                           combiner=combiner, **tiling)
    assert out.shape == (num_rows, msgs_pad.shape[1])
    rtol, atol = TOL[combiner]
    for kw in JAX_PATHS:
        expect = jops.segment_spmm(jnp.asarray(msgs_pad),
                                   jnp.asarray(local_dst), num_rows,
                                   combiner=combiner, **tiling, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                                   rtol=rtol, atol=atol)
    return out


@pytest.mark.parametrize("combiner", ["sum", "max"])
@pytest.mark.parametrize("e,v,f", [(257, 256, 128), (1024, 512, 256),
                                   (50, 256, 4), (2000, 768, 128)])
def test_segment_spmm_matches_jax(e, v, f, combiner):
    """Sweep of tests/test_kernels.py, F=4 (the GAT score width) included;
    rows no edge reaches are 0 (sum) or -inf (max) on both sides."""
    _, _, msgs_pad, local_dst, rows_p = _layout(e, v, f, combiner, e + v + f)
    _check(msgs_pad, local_dst, rows_p, combiner)


@pytest.mark.parametrize("combiner", ["sum", "max"])
def test_segment_spmm_unpadded_num_rows(combiner):
    """num_rows may be unpadded: the grid comes from tiled_shape."""
    _, _, msgs_pad, local_dst, _ = _layout(900, 300, 8, combiner, 5)
    _check(msgs_pad, local_dst, 300, combiner)


@pytest.mark.parametrize("tile_v,block_e", [(128, 256), (64, 128), (512, 512)])
@pytest.mark.parametrize("combiner", ["sum", "max"])
def test_segment_spmm_nondefault_tiling(tile_v, block_e, combiner):
    tiling = {"tile_v": tile_v, "block_e": block_e}
    _, _, msgs_pad, local_dst, rows_p = _layout(
        900, 700, 32, combiner, tile_v + block_e, **tiling)
    _check(msgs_pad, local_dst, rows_p, combiner, **tiling)


@pytest.mark.parametrize("case", ["empty_tiles", "ragged_e", "tiny_rows"])
def test_segment_spmm_ragged_layouts(case):
    rng = np.random.default_rng(0)
    f = 16
    if case == "empty_tiles":
        v, e = 1024, 300
        dst = rng.integers(0, 128, e).astype(np.int32)  # tiles 1..3 empty
    elif case == "ragged_e":
        v, e = 512, 515
        dst = rng.integers(0, v, e).astype(np.int32)
    else:
        v, e = 7, 40  # num_rows < tile_v
        dst = rng.integers(0, v, e).astype(np.int32)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    order, local_dst, rows_p = jops.prepare_tiled_edges(dst, v)
    for combiner, fill in (("sum", 0.0), ("max", -np.inf)):
        msgs_pad = np.concatenate(
            [msgs, np.full((1, f), fill, np.float32)])[order]
        _check(msgs_pad, local_dst, rows_p, combiner)


@pytest.mark.parametrize("combiner", ["sum", "max"])
def test_segment_spmm_valid_mask_and_per_tile(combiner):
    """Dropped (`valid`-masked) edges and a forced per_tile."""
    rng = np.random.default_rng(3)
    v, e = 300, 400
    dst = rng.integers(0, v, e).astype(np.int32)
    valid = rng.random(e) < 0.5
    order, local_dst, rows_p = jops.prepare_tiled_edges(
        dst, v, per_tile=1024, valid=valid)
    msgs = rng.normal(size=(e, 8)).astype(np.float32)
    fill = 0.0 if combiner == "sum" else -np.inf
    msgs_pad = np.concatenate([msgs, np.full((1, 8), fill, np.float32)])[order]
    _check(msgs_pad, local_dst, rows_p, combiner)


def test_plain_version_is_the_ref_on_global_ids():
    """The plain path rebuilds global ids from tile-relative local_dst: it
    equals segment_*_ref on the original (dst, messages)."""
    dst, msgs, msgs_pad, local_dst, rows_p = _layout(2000, 768, 16, "sum", 9)
    out = spmm.segment_spmm_plain(torch.as_tensor(msgs_pad),
                                  torch.as_tensor(local_dst), rows_p)
    expect = ref.segment_sum_ref(torch.as_tensor(msgs),
                                 torch.as_tensor(dst).long(), 768)
    torch.testing.assert_close(out[:768], expect, rtol=1e-5, atol=8e-5)
    assert not out[768:].any()  # rows no edge reaches are 0


@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("backend", ["scatter", "tiled"])
def test_aggregate_matches_jax(backend, reduce):
    """ops.aggregate on the original edge order, with dropped edges and the
    dst == num_rows sink, against repro.kernels.ops.aggregate."""
    rng = np.random.default_rng(11)
    e, v, f = 1500, 600, 12
    dst = rng.integers(0, v + 1, e).astype(np.int32)  # v is the sink row
    valid = dst < v
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    if reduce == "sum":
        msgs = msgs * valid[:, None]
    else:
        msgs = np.where(valid[:, None], msgs, -1e30).astype(np.float32)
    order, local_dst, _ = jops.prepare_tiled_edges(dst, v + 1, valid=valid)
    expect = jops.aggregate(
        jnp.asarray(msgs), jnp.asarray(dst), v + 1,
        edge_order=jnp.asarray(order), local_dst=jnp.asarray(local_dst),
        backend=backend, reduce=reduce)
    out = ops.aggregate(
        torch.as_tensor(msgs), torch.as_tensor(dst), v + 1,
        edge_order=torch.as_tensor(order), local_dst=torch.as_tensor(local_dst),
        backend=backend, reduce=reduce)
    expect = np.asarray(expect)
    if reduce == "max":  # scatter sees -1e30 where tiled dropped the edge
        expect, out = np.maximum(expect, -1e29), torch.clamp(out, min=-1e29)
    rtol, atol = TOL[reduce]
    np.testing.assert_allclose(np.asarray(out), expect, rtol=rtol, atol=atol)


def test_pallas_backend_raises_on_cpu_tensors():
    """'pallas' forces the CUDA kernel: on CPU tensors it raises rather
    than falling back to the plain version."""
    dst = np.array([0, 1, 1], np.int32)
    order, local_dst, _ = jops.prepare_tiled_edges(dst, 2)
    with pytest.raises(ValueError, match="pallas"):
        ops.aggregate(torch.ones(3, 4), torch.as_tensor(dst), 2,
                      edge_order=torch.as_tensor(order),
                      local_dst=torch.as_tensor(local_dst), backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm.segment_spmm(torch.zeros(512, 4),
                          torch.zeros(512, dtype=torch.int32), 256)


def test_kernel_wrapper_refuses_gradients_and_bad_layouts():
    """The kernel path is forward only, and checks its layout before any
    launch."""
    msgs = torch.zeros(512, 4, requires_grad=True)
    ldst = torch.zeros(512, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward only"):
        spmm.segment_spmm(msgs, ldst, 256)
    with pytest.raises(AssertionError, match="tiled layout mismatch"):
        ops.segment_spmm(torch.zeros(3, 8), torch.zeros(3, dtype=torch.int32),
                         300)
    with pytest.raises(ValueError, match="not a positive multiple"):
        spmm.segment_spmm_plain(torch.zeros(512, 8), ldst, 300)
    with pytest.raises(ValueError, match="do not split"):
        spmm.segment_spmm_plain(torch.zeros(3, 8),
                                torch.zeros(3, dtype=torch.int32), 512)


def test_kernel_source_exists_and_counters_start_at_zero():
    """The CUDA source ships in the package; a CPU run never counts a
    launch."""
    assert spmm.SOURCE.is_file()
    text = spmm.SOURCE.read_text()
    assert 'extern "C"' in text and "sm_90a" in text
    before = dict(spmm.LAUNCHES)
    _, _, msgs_pad, local_dst, rows_p = _layout(257, 256, 8, "sum", 1)
    ops.segment_spmm(torch.as_tensor(msgs_pad), torch.as_tensor(local_dst),
                     rows_p)
    assert spmm.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_v", [128, 256, 512])
@pytest.mark.parametrize("f", [1, 4, 16, 100, 128, 512, 1000])
def test_launch_plan_owns_every_element_once(f, tile_v, dtype):
    """The kernel's launch plan (csrc/segment_reduce.cu reads it as
    `LaunchPlan` documents): in every segment of a row tile, each (row,
    column) has exactly one owning (block, warp, lane); the segments cover
    the tile's slots; and the plan fits the card: dynamic shared memory
    <= 232,448 B, <= 1,024 threads, grid <= 2^31 - 1."""
    dt = getattr(torch, dtype)
    n_tiles, per_tile = 272, 56_832
    plan = spmm._launch_plan(n_tiles, per_tile, tile_v, f, dt)
    b = dt.itemsize
    assert f % plan.vec == 0 and plan.vec * b <= 16
    assert 32 % plan.lanes == 0 and plan.warps & (plan.warps - 1) == 0
    assert plan.smem == spmm._smem_bytes(tile_v, plan.cols, plan.stage,
                                         plan.warps, plan.units)
    assert plan.smem <= 232_448 and plan.threads <= 1024
    assert plan.grid == n_tiles * plan.n_splits * plan.n_col_groups
    assert plan.grid <= 2**31 - 1
    assert plan.stage % 128 == 0 and plan.stage <= 65_536
    # the segments of a tile cover its slots, none of them empty
    assert plan.seg % plan.stage == 0
    assert (plan.n_splits - 1) * plan.seg < per_tile <= plan.n_splits * plan.seg
    owners = np.zeros((tile_v, f), np.int64)
    per_warp = 32 // plan.lanes
    for group in range(plan.n_col_groups):  # the blocks of one segment
        for warp in range(plan.warps):
            for lane in range(32):
                unit = warp * per_warp + lane // plan.lanes
                col = group * plan.cols + (lane % plan.lanes) * plan.vec
                if col >= f:
                    continue
                owners[unit::plan.units, col:col + plan.vec] += 1
    assert (owners == 1).all()
    # a message row misaligned to 4 bytes takes narrower loads
    narrow = spmm._launch_plan(n_tiles, per_tile, tile_v, f, dt, align=b)
    assert narrow.vec == 1


@pytest.mark.parametrize("n_tiles,per_tile,tile_v,f", [
    (1, 512, 60_000, 1),          # the fp32 accumulator exceeds 227 KB
    (2**31, 512, 256, 4),         # more blocks than a grid holds
    (2**28, 512, 256, 1000),      # the same through column groups
    (4, 0, 256, 4),               # an empty tile
])
def test_launch_plan_refuses_what_it_cannot_cover(n_tiles, per_tile,
                                                  tile_v, f):
    with pytest.raises(ValueError):
        spmm._launch_plan(n_tiles, per_tile, tile_v, f, torch.float32)


@pytest.mark.parametrize("seg", [None, 128])
@pytest.mark.parametrize("e,v,f", [(257, 256, 128), (1024, 512, 256),
                                   (50, 256, 4), (2000, 768, 128)])
def test_layout_order_fold_matches_jax(e, v, f, seg):
    """chip_smoke.py holds the card's fp32 sum bit for bit against a
    layout-order np.add.at fold (in the launch plan's segments when it
    splits tiles); that oracle itself equals the JAX reference (jnp path)
    at this file's tolerances."""
    fold = _chip_smoke().layout_fold
    _, _, msgs_pad, local_dst, rows_p = _layout(e, v, f, "sum", e + v + f,
                                                per_tile=1024)
    expect = jops.segment_spmm(jnp.asarray(msgs_pad), jnp.asarray(local_dst),
                               rows_p, combiner="sum", use_pallas=False)
    out = fold(msgs_pad, local_dst, rows_p, seg=seg)
    assert out.dtype == np.float32 and out.shape == (rows_p, f)
    np.testing.assert_allclose(out, np.asarray(expect), *TOL["sum"])
    # the kernel's plain version agrees too
    plain = spmm.segment_spmm_plain(torch.as_tensor(msgs_pad),
                                    torch.as_tensor(local_dst), rows_p)
    np.testing.assert_allclose(out, plain.numpy(), *TOL["sum"])
