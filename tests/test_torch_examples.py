"""The port's example drivers can't rot: both run end to end at tiny
scale on the CPU, as subprocesses (exactly how a user runs them), and
print what tests/test_examples.py asserts of the reference's drivers."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(REPO, "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *argv,
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=600,
    )


def test_torch_quickstart_runs():
    r = _run("torch_quickstart.py", "--scale", "0.01", "--k", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "tiled agg backend == scatter oracle" in out
    assert "minibatch cache=degree" in out
    # the invariant lines actually printed small errors
    for line in out.splitlines():
        if "max err" in line:
            assert float(line.split()[-1]) < 1e-3, line


def test_torch_partitioning_study_runs():
    r = _run("torch_gnn_partitioning_study.py", "--scale", "0.01", "--k", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "DistGNN regime" in out
    assert "DistDGL regime" in out
    assert "serving regime" in out
    assert "hit_rate" in out
