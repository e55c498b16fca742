"""Run a function of the package in k processes, one a rank of a mesh.

    results = run_ranks(fullbatch_dist.run_cases, 4, backend="gloo",
                        device="cuda", args=(path,))

`start_ranks` spawns `world_size` Python processes. Each one imports the
package (never JAX, never the caller's modules), joins the mesh
(launch/mesh.py: `make_mesh` over a file rendezvous in a fresh temporary
directory, so concurrent launches never share a port), runs
`target(mesh, *args)` and writes its return value back; `Ranks.join`
returns the values by rank. On the CPU each rank takes one thread.

Nothing hangs: the rendezvous and every collective time out after
`mesh.INIT_TIMEOUT` seconds, and the whole launch after `timeout`. When a
rank raises or dies, the other ranks are killed and `join` raises `RankError`
with that rank's traceback (or the tail of its error output); when the
launch runs past `timeout`, every rank is killed and `join` raises
`TimeoutError`. The target must be a module-level function of
`repro_torch`, and its arguments and result must pickle.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

from repro_torch.launch.mesh import AXIS, make_mesh

SRC = Path(__file__).resolve().parents[2]  # the directory holding repro_torch
CHILD = "from repro_torch.launch.ranks import _child; _child()"


class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback."""


def _target_name(target) -> str:
    name = f"{target.__module__}:{target.__qualname__}"
    if not target.__module__.startswith("repro_torch.") or "." in \
            target.__qualname__:
        raise ValueError(f"{name}: a rank runs a module-level function of "
                         "repro_torch")
    return name


class Ranks:
    """`world_size` running rank processes; `join` waits for them."""

    def __init__(self, target, world_size: int, *, backend: str,
                 device: str, args: tuple, timeout: float):
        spec = {"target": _target_name(target), "args": args,
                "backend": backend, "device": device,
                "world_size": world_size}
        self.dir = Path(tempfile.mkdtemp(prefix="repro_torch_ranks_"))
        self.world_size = world_size
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.procs = []
        with open(self.dir / "spec.pkl", "wb") as f:
            pickle.dump(spec, f, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            for rank in range(world_size):
                env = dict(os.environ, RANK=str(rank),
                           WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                           PYTHONPATH=os.pathsep.join(
                               [str(SRC)] + [p for p in os.environ.get(
                                   "PYTHONPATH", "").split(os.pathsep) if p]))
                with open(self.dir / f"err_{rank}.txt", "wb") as err:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-c", CHILD, str(self.dir)],
                        env=env, stdout=err, stderr=subprocess.STDOUT))
        except BaseException:
            self.close()
            raise

    def _failure(self, codes: list) -> RankError:
        """The failed ranks' tracebacks (or error output tails), the first
        written first: a peer of the rank at fault may fail too, in the
        collective it was waiting in."""
        texts = []
        for rank, code in enumerate(codes):
            if code in (None, 0):
                continue
            tb = self.dir / f"traceback_{rank}.txt"
            path = tb if tb.exists() else self.dir / f"err_{rank}.txt"
            texts.append((path.stat().st_mtime, rank,
                          f"rank {rank} of {self.world_size} exited with "
                          f"code {code}:\n"
                          + path.read_text(errors="replace")[-4000:]))
        return RankError("\n".join(text for *_, text in sorted(texts)))

    def join(self) -> list:
        """The ranks' return values, by rank; raises `RankError` if a rank
        failed and `TimeoutError` past the launch's timeout."""
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                if any(code not in (None, 0) for code in codes):
                    raise self._failure(codes)
                if all(code == 0 for code in codes):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(
                        f"{self.world_size} ranks still running after "
                        f"{self.timeout} s (ranks "
                        f"{[r for r, c in enumerate(codes) if c is None]})")
                time.sleep(0.05)
            out = []
            for rank in range(self.world_size):
                with open(self.dir / f"result_{rank}.pkl", "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self.close()

    def close(self) -> None:
        """Kill every rank still running and remove the launch's files."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def start_ranks(target, world_size: int, *, backend: str = "gloo",
                device: str = "cuda", args: tuple = (),
                timeout: float = 600.0) -> Ranks:
    """Spawn the ranks and return at once; `join()` collects them."""
    return Ranks(target, world_size, backend=backend, device=device,
                 args=args, timeout=timeout)


def run_ranks(target, world_size: int, **kw) -> list:
    """`start_ranks(...).join()`: the ranks' return values, by rank."""
    return start_ranks(target, world_size, **kw).join()


def _child() -> None:
    """A rank's main: join the mesh, run the target, write its value (or
    its traceback, then exit 1)."""
    import importlib
    import torch.distributed as dist

    run_dir = Path(sys.argv[1])
    rank = int(os.environ["RANK"])
    try:
        with open(run_dir / "spec.pkl", "rb") as f:
            spec = pickle.load(f)
        if spec["device"] == "cpu":
            torch.set_num_threads(1)
        mesh = make_mesh((spec["world_size"],), (AXIS,),
                         backend=spec["backend"], device=spec["device"],
                         init_method=f"file://{run_dir / 'rendezvous'}")
        module, name = spec["target"].split(":")
        result = getattr(importlib.import_module(module), name)(
            mesh, *spec["args"])
        tmp = run_dir / f"result_{rank}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, run_dir / f"result_{rank}.pkl")
        dist.destroy_process_group()
    except BaseException:
        (run_dir / f"traceback_{rank}.txt").write_text(traceback.format_exc())
        sys.stdout.flush()
        # no interpreter teardown: a peer may still wait in a collective
        # with this rank's process group
        os._exit(1)
