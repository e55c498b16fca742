#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; each one asserts, and nothing is caught, so any failure
ends the script with a traceback and a non-zero exit:

  1. device  — the card's name and power limit (nvidia-smi) and
               torch.cuda.get_device_name().
  2. build   — compile kernels/csrc/segment_reduce.cu with nvcc for sm_90a
               (the ptxas register / shared-memory report is printed).
  3. kernels — the hand kernel against its plain PyTorch version on the
               card, sum and max, fp32 and bf16: the shapes of
               tests/test_kernels.py and the edge cases (an unreached row,
               the -inf pad row, dropped edges). Per shape: max error,
               kernel / plain / library / bound ms.
  4. serve   — the port's `gnn_serve` entry point at full width (GAT, then
               SAGE: --features 512 --hidden 512 --layers 3 --classes 16,
               4 heads) on OR scale 1.0, hep100, k=4, tiled (the kernel),
               with the launch counters set to 0 before and read after each
               run; then the same runs with --agg-backend scatter, held at
               rtol=atol=2e-4; and a small run on the card held against the
               same run on the CPU. p50/p99 latencies are modeled on the
               paper's cluster by `serve_request`; host compute and layer
               times are measured on the card.
  5. shapes  — every (combiner, rows, F) the kernel ran at in phase 4,
               again on the `local_dst` that phase 4 passed it (kept from
               its first launch) with random messages: the kernel against
               its plain version, and kernel / plain / library / bound ms.

It prints one JSON object {"kernels": [...]} on a line of its own, one
entry per shape of phase 5 with the launches phase 4 made at that shape,
then the card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Per-shape results also go to chiprun_out/chip_smoke_kernels.json.
`python3 chip_smoke.py --profile` runs only the device and build phases and
a torch.profiler pass over the GAT main path's layer-wise inference.

It exits non-zero when no GPU is visible and when `src/repro_torch` is not
beside it. It imports nothing of JAX and nothing of `repro`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, H100 SXM
SERVE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_gnn_distributed.py:38
# A sum of n unit-normal terms taken in two orders (the kernel's layout
# order, the plain version's atomics) differs by O(sqrt(n)) ulps of the
# partial sums: past this many terms a row's atol grows as sqrt(n / it).
SUM_TERMS_AT_TEST_TOL = 64
KERNEL_TOL = {  # (rtol, atol), tests/test_kernels.py:26,46
    ("sum", "float32"): (1e-5, 8e-5),
    ("max", "float32"): (1e-6, 8e-6),
    ("sum", "bfloat16"): (2e-2, 1.6e-1),
    ("max", "bfloat16"): (2e-2, 1.6e-1),
}
FULL_WIDTH = ["--graph", "OR", "--scale", "1.0", "--partitioner", "hep100",
              "--k", "4", "--features", "512", "--hidden", "512",
              "--layers", "3", "--classes", "16", "--hops", "1",
              "--fanout", "10", "--batch", "32", "--requests", "200",
              "--device", "cuda"]


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------- phase 1
def phase_device(torch) -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"[device] nvidia-smi: {smi}")
    say(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi, kind


# ---------------------------------------------------------------- phase 2
def phase_build(spmm) -> float:
    t0 = time.perf_counter()
    path = spmm.build()
    seconds = time.perf_counter() - t0
    spmm.load()
    say(f"[build] {path.name} in {seconds:.2f}s")
    for line in (spmm.build_log or "").splitlines():
        if "registers" in line or "error" in line.lower():
            say(f"[build]   {line.strip()}")
    return seconds


# ---------------------------------------------------------------- phase 3
def _time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(torch, a, b) -> float:
    a, b = a.float(), b.float()
    same = a == b  # equal infinities count as no error
    return float(torch.where(same, 0.0, (a - b).abs()).max())


def check_kernel(torch, spmm, name, msgs, ldst, rows, combiner, *,
                 tile_v=256, block_e=512, reps=10):
    """Hold the kernel against its plain version on the same inputs and
    time kernel, plain version, library call and bound."""
    e, f = msgs.shape
    per_tile = e // (rows // tile_v)
    real = ldst != tile_v
    tile_idx = torch.arange(e, device=msgs.device) // per_tile
    gdst = (tile_idx * tile_v + ldst.long())[real]
    lib_msgs = msgs[real]
    n_real = int(real.sum())
    # the most edges any one row receives
    n_max = int(torch.bincount(gdst, minlength=rows).max()) if n_real else 0

    out = spmm.segment_spmm(msgs, ldst, rows, combiner=combiner,
                            tile_v=tile_v, block_e=block_e)
    torch.cuda.synchronize()
    plain = spmm.segment_spmm_plain(msgs, ldst, rows, combiner=combiner,
                                    tile_v=tile_v)
    dtype = str(msgs.dtype).replace("torch.", "")
    rtol, atol = KERNEL_TOL[(combiner, dtype)]
    if combiner == "sum" and n_max > SUM_TERMS_AT_TEST_TOL:
        atol *= math.sqrt(n_max / SUM_TERMS_AT_TEST_TOL)
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol, equal_nan=False)
    err = _max_abs_err(torch, out, plain)
    lib_out = torch.full((rows, f), 0.0 if combiner == "sum" else
                         float("-inf"), dtype=msgs.dtype, device=msgs.device)
    if combiner == "sum":
        def library():
            lib_out.index_add_(0, gdst, lib_msgs)
    else:
        idx = gdst[:, None].expand(-1, f)

        def library():
            lib_out.scatter_reduce_(0, idx, lib_msgs, reduce="amax",
                                    include_self=True)
    ms = _time_ms(torch, lambda: spmm.segment_spmm(
        msgs, ldst, rows, combiner=combiner, tile_v=tile_v,
        block_e=block_e), reps)
    plain_ms = _time_ms(torch, lambda: spmm.segment_spmm_plain(
        msgs, ldst, rows, combiner=combiner, tile_v=tile_v), max(reps // 3, 1))
    library_ms = _time_ms(torch, library, reps)

    b = msgs.element_size()
    # bytes this run's data needs: the real edges' messages (pad messages
    # are never read), every local_dst, every output row
    nbytes = n_real * f * b + 4 * e + rows * f * b
    ops = n_real * f
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    row = {
        "shape": name, "combiner": combiner, "dtype": dtype,
        "E_tiled": e, "real_edges": n_real, "rows": rows, "F": f,
        "max_edges_per_row": n_max,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tol": [rtol, atol],
    }
    say(f"[kernels] {name:<28} {combiner} {dtype:<8} F={f:<4} "
        f"E_tiled={e:<9} real={n_real:<8} n_max={n_max:<5} err={err:.3g} "
        f"atol={atol:.3g} ms={ms:.4f} "
        f"plain={plain_ms:.4f} library={library_ms:.4f} "
        f"bound={row['bound_ms']:.4f} ({row['bound_by']})")
    return row, out


def _test_layout(torch, tiling, e, v, f, seed, dtype, fill, valid=None,
                 per_tile=None):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, v, e).astype(np.int32)
    msgs = rng.normal(size=(e, f)).astype(np.float32)
    order, ldst, rows = tiling.prepare_tiled_edges(
        dst, v, valid=valid, per_tile=per_tile)
    msgs_pad = np.concatenate([msgs, np.full((1, f), fill, np.float32)])[order]
    dev = torch.device("cuda")
    return (torch.as_tensor(msgs_pad, device=dev).to(dtype),
            torch.as_tensor(ldst, device=dev), rows, dst)


def or_layout(graph_mod, ep, book_mod, partitioner):
    """The folded [k * E_tiled] local_dst of an edge book over OR scale 1.0,
    k=4 (the main path's graph and k) under `partitioner`."""
    g = graph_mod.paper_graph("OR", scale=1.0, seed=0)
    a = ep.partition_edges(g, 4, partitioner, seed=0)
    book = book_mod.build_edge_book(g, a, 4, tiled_layout=True)
    return book.agg_ldst.reshape(-1), book


def _padding(ldst_np, tile_v=256) -> str:
    real = int((ldst_np != tile_v).sum())
    return (f"E_tiled={ldst_np.size} real={real} "
            f"padding={ldst_np.size / max(real, 1):.3f}x")


def phase_kernels(torch, spmm, tiling, graph_mod, ep, book_mod) -> list:
    rows_out = []
    f32, bf16 = torch.float32, torch.bfloat16
    for combiner, fill in (("sum", 0.0), ("max", float("-inf"))):
        for dtype in (f32, bf16):
            for e, v, f in [(257, 256, 128), (1024, 512, 256), (50, 256, 4),
                            (2000, 768, 128)]:
                msgs, ldst, rows, dst = _test_layout(
                    torch, tiling, e, v, f, e + v + f, dtype, fill)
                row, out = check_kernel(torch, spmm, f"test {e}x{v}", msgs,
                                        ldst, rows, combiner)
                rows_out.append(row)
                # an unreached row comes back as the combiner identity
                unreached = np.setdiff1d(np.arange(rows), dst)
                assert unreached.size > 0
                idx = torch.as_tensor(unreached, device=out.device)
                assert bool((out[idx] == fill).all()), "unreached row"
        # dropped (valid-masked) edges and a forced per_tile
        rng = np.random.default_rng(3)
        valid = rng.random(400) < 0.5
        msgs, ldst, rows, _ = _test_layout(torch, tiling, 400, 300, 8, 3, f32,
                                           fill, valid=valid, per_tile=1024)
        rows_out.append(check_kernel(torch, spmm, "dropped edges", msgs,
                                     ldst, rows, combiner)[0])
    # the -inf pad row passes through a max untouched, even when it is the
    # only message a row sees
    msgs = torch.full((512, 4), float("-inf"), device="cuda")
    ldst = torch.full((512,), 256, dtype=torch.int32, device="cuda")
    ldst[:3] = torch.tensor([0, 0, 5], dtype=torch.int32)
    msgs[1] = 2.0
    out = spmm.segment_spmm(msgs, ldst, 256, combiner="max")
    assert bool((out[0] == 2.0).all()) and bool(torch.isneginf(out[5]).all())
    assert bool(torch.isneginf(out[1:5]).all())
    # the same graph's layout under random edges, beside the main path's
    # (phase 5): the padding a row tile carries depends on the partitioner
    random_ldst, _ = or_layout(graph_mod, ep, book_mod, "random")
    say(f"[kernels] layout under random (OR 1.0, k=4): {_padding(random_ldst)}")
    return rows_out


# ---------------------------------------------------------------- phase 4
def serve_once(torch, spmm, gnn_serve, argv, label, seen=None):
    """One gnn_serve run with the launch counters set to 0 just before it
    and read just after. With `seen`, the local_dst and dtype of the first
    launch at each (combiner, rows, F) are kept there for phase 5."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch = spmm.segment_spmm

    def keep_inputs(messages, local_dst, num_rows, *, combiner="sum", **kw):
        key = (combiner, num_rows, messages.shape[1])
        if key not in seen:
            seen[key] = (local_dst.clone(), messages.dtype, kw)
        return launch(messages, local_dst, num_rows, combiner=combiner, **kw)

    if seen is not None:
        spmm.segment_spmm = keep_inputs
    spmm.LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            out = gnn_serve.run(argv)
    finally:
        spmm.segment_spmm = launch
    wall = time.perf_counter() - t0
    launches = dict(spmm.LAUNCHES)
    rep = out.report
    peak = torch.cuda.max_memory_allocated()
    for e in out.embeddings:
        assert e.shape[0] == out.graph.num_vertices and np.isfinite(e).all()
    assert rep.served() == 200 and np.isfinite(rep.logits).all()
    assert rep.logits.shape == (200, out.spec.num_classes)
    shown = {f"{c} rows={r} F={f}": n for (c, r, f), n in sorted(launches.items())}
    say(f"[serve] {label}: launches {shown}, layer seconds "
        f"{[round(t, 4) for t in out.inference.layer_times]}, host compute "
        f"p50 {np.percentile(rep.host_time, 50) * 1e3:.3f} ms/batch over "
        f"{len(rep.host_time)} batches, peak device memory "
        f"{peak / 2**30:.2f} GiB, served {rep.served()}, modeled p50 "
        f"{rep.p50() * 1e3:.3f} ms p99 {rep.p99() * 1e3:.3f} ms, wall "
        f"{wall:.1f}s")
    return out, launches


def _launched(launches, combiner) -> int:
    return sum(n for (c, _, _), n in launches.items() if c == combiner)


def _hold(a, b, what):
    np.testing.assert_allclose(a, b, err_msg=what, **SERVE_TOL)
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    say(f"[serve] {what}: max |diff| {diff:.3g} (rtol=atol=2e-4)")


def phase_serve(torch, spmm, gnn_serve) -> tuple[dict, dict]:
    """The main path. Returns the launches of each tiled run by model, and
    the inputs of the first launch at each shape (for phase 5)."""
    main_launches, seen = {}, {}
    for model in ("gat", "sage"):
        tiled, launches = serve_once(
            torch, spmm, gnn_serve,
            FULL_WIDTH + ["--model", model, "--agg-backend", "tiled"],
            f"{model} tiled (the kernel)", seen)
        assert _launched(launches, "sum") > 0, f"{model}: sum never launched"
        if model == "gat":
            assert _launched(launches, "max") > 0, "gat: max never launched"
        main_launches[model] = launches
        emb, logits = tiled.embeddings, tiled.report.logits
        ids = tiled.report.served_ids
        del tiled
        plain, launches = serve_once(
            torch, spmm, gnn_serve,
            FULL_WIDTH + ["--model", model, "--agg-backend", "scatter"],
            f"{model} scatter (plain)")
        assert not launches, launches
        np.testing.assert_array_equal(ids, plain.report.served_ids)
        for li, (a, b) in enumerate(zip(emb, plain.embeddings)):
            _hold(a, b, f"{model} layer {li} embeddings, kernel vs scatter")
        _hold(logits, plain.report.logits,
              f"{model} served logits, kernel vs scatter")
        del plain, emb, logits

    # a small input, on the card and on the CPU
    small = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--model", "gat",
             "--agg-backend", "tiled", "--features", "32", "--hidden", "32",
             "--layers", "3", "--requests", "60", "--qps", "300"]
    with torch.inference_mode():
        gpu = gnn_serve.run(small + ["--device", "cuda"])
        cpu = gnn_serve.run(small + ["--device", "cpu"])
    for li, (a, b) in enumerate(zip(gpu.embeddings, cpu.embeddings)):
        _hold(a, b, f"small gat layer {li}, card vs cpu")
    _hold(gpu.report.logits, cpu.report.logits, "small gat logits, card vs cpu")
    return main_launches, seen


# ---------------------------------------------------------------- phase 5
def phase_shapes(torch, spmm, seen) -> dict:
    """The kernel at every shape phase 4 launched it at, on that launch's
    local_dst with random messages (pad messages are never read)."""
    rows_out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for key in sorted(seen):
        combiner, rows, f = key
        ldst, dtype, kw = seen[key]
        msgs = torch.randn(ldst.numel(), f, device="cuda", generator=gen)
        msgs[ldst == kw.get("tile_v", 256)] = (
            0.0 if combiner == "sum" else float("-inf"))
        big = ldst.numel() * f > 1 << 26
        rows_out[key], _ = check_kernel(
            torch, spmm, f"main path rows={rows}", msgs.to(dtype), ldst, rows,
            combiner, reps=3 if big else 20, **kw)
        del msgs
        torch.cuda.empty_cache()
    layerwise = max(seen[key][0].numel() for key in seen)
    for ldst, _, _ in seen.values():
        if ldst.numel() == layerwise:
            say(f"[shapes] main-path layout (OR 1.0, hep100, k=4): "
                f"{_padding(ldst.cpu().numpy())}")
            break
    return rows_out


# --------------------------------------------------------------- profile
def phase_profile(torch, gnn_serve) -> None:
    """`--profile`: the GAT main path's layer-wise pass, run again warm,
    then once under torch.profiler. Prints warm layer seconds, device time
    by op, and the device idle share of the profiled pass (1 - summed
    kernel time / wall; one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        out = gnn_serve.run(FULL_WIDTH + ["--requests", "1", "--model",
                                          "gat", "--agg-backend", "tiled"])
        eng = out.inference
        eng.run()
        say(f"[profile] warm layer seconds {eng.layer_times}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run()
            wall = time.perf_counter() - t0
    avg = prof.key_averages()
    say(avg.table(sort_by="self_device_time_total", row_limit=20))
    # device-side events only (kernels, copies, sets): a CPU op's own
    # device time would count its kernels a second time
    busy_us = sum(e.self_device_time_total for e in avg
                  if e.device_type == DeviceType.CUDA)
    say(f"[profile] wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}")


# ------------------------------------------------------------------ main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device is visible; this script runs the "
            "port on the card only")
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        say(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
            "from the root of a checkout")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import edge_partition as ep
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import partition_book as book_mod
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import segment_spmm as spmm
    from repro_torch.kernels import tiling
    from repro_torch.launch import gnn_serve

    resolve_device("cuda")
    t_start = time.perf_counter()
    smi, kind = phase_device(torch)
    phase_build(spmm)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, gnn_serve)
        return 0
    rows_out = phase_kernels(torch, spmm, tiling, graph_mod, ep, book_mod)
    launches, seen = phase_serve(torch, spmm, gnn_serve)
    shapes = phase_shapes(torch, spmm, seen)

    kernels = []
    for (combiner, rows, f), row in shapes.items():
        by_run = {m: n.get((combiner, rows, f), 0) for m, n in launches.items()}
        kernels.append({
            "name": f"segment_reduce_{combiner}[rows={rows},F={f}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
            "replaces": "src/repro/kernels/segment_spmm.py:59",
            # launches at this shape over the GAT and SAGE tiled runs
            "launches": sum(by_run.values()),
            "launches_by_run": by_run,
            "E_tiled": row["E_tiled"],
            "real_edges": row["real_edges"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_kernels.json").write_text(
        json.dumps(rows_out + list(shapes.values()), indent=1) + "\n")
    say(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
