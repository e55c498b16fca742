"""The port's serving CLI, its device rule and its import hygiene.

  * `python -m repro_torch.launch.gnn_serve --device cpu` runs at a tiny
    size and answers every request
  * without `--device cpu` on a machine with no CUDA it raises at once:
    entry points run on the card and never fall back
  * no module of `src/repro_torch/`, and not `chip_smoke.py`, imports JAX
    or the JAX package (`repro`)
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import gnn_serve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--graph", "OR", "--scale", "0.02", "--k", "2", "--features", "8",
        "--hidden", "8", "--classes", "4", "--requests", "30", "--qps", "500"]


@pytest.mark.parametrize("model,backend,partitioner", [
    ("sage", "scatter", "hep100"),
    ("gat", "tiled", "hep100"),
    ("gcn", "tiled", "metis"),
])
def test_cli_serves_every_request_on_cpu(model, backend, partitioner, capsys):
    out = gnn_serve.run(TINY + ["--device", "cpu", "--model", model,
                                "--agg-backend", backend, "--layers", "3",
                                "--partitioner", partitioner])
    assert out.report.served() == 30
    assert out.report.logits.shape == (30, 4)
    assert len(out.embeddings) == 3
    assert all(e.shape[0] == out.graph.num_vertices for e in out.embeddings)
    text = capsys.readouterr().out
    assert "served 30 requests" in text and "on cpu" in text


def test_cli_module_entry_point_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gnn_serve", "--device",
         "cpu", *TINY], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 30 requests" in proc.stdout


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """The default device is the card; with no GPU visible the entry point
    raises before doing any work instead of running on the CPU."""
    assert gnn_serve.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_serve.run(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_serve.run(TINY + ["--device", "cuda"])


def test_unknown_partitioner_is_rejected():
    with pytest.raises(ValueError, match="unknown partitioner"):
        gnn_serve.run(TINY + ["--device", "cpu", "--partitioner", "nope"])


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("banned", ["jax", "repro"])
def test_port_imports_neither_jax_nor_the_jax_package(banned):
    files = _port_files()
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f)
           if m == banned or m.startswith(banned + ".")]
    assert not bad, f"imports of {banned}: {bad}"
