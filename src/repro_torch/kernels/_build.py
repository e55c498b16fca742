"""Build a CUDA source under csrc/ into a shared library and bind it.

Each kernel module keeps one `CudaLibrary`: a .cu file with a plain C
interface, compiled with nvcc for sm_90a at first use into `build/repro_torch/`
at the repository root (git-ignored), under a name made from a hash of the
source, the nvcc flags and the nvcc version, and loaded with ctypes. Nothing
is built at import, so the CPU tests import every module without nvcc. A
failed build raises. Builds of different libraries may run at once (each is
its own nvcc process writing to its own file): `build_all` starts them
together.
`BUILDS` counts, per library, the nvcc builds this process ran and the
libraries it loaded: the port's only compiles, which `gnn_lint`'s
retrace guard (`analysis.rules.count_builds`) holds to 0 in a warm sweep.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc builds and library loads per (library name, "build" | "load")
BUILDS: Counter = Counter()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
            "are built from source at first use")
    return str(path)


class CudaLibrary:
    """One csrc/ source, its shared library and its ctypes binding.

    `bind(lib)` sets argtypes / restype of the library's entry points
    (c_void_p for every pointer and for the stream); the library also
    exports `<name>_error_string(int)`, which `check` reads. `build_log` holds what
    nvcc printed (the ptxas register / shared-memory report) once this
    process built the library; it stays None when the library was already
    built."""

    def __init__(self, source: str, name: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.name = name
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self.build_log: str | None = None

    def build(self) -> Path:
        """Compile the source (if this source has not been built yet) and
        return the shared library's path."""
        cc = nvcc()
        version = subprocess.run([cc, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        # the library's name changes with the source, the flags and the
        # compiler
        key = b"\0".join([self.source.read_bytes(),
                          " ".join(NVCC_FLAGS).encode(), version.encode()])
        digest = hashlib.sha256(key).hexdigest()[:12]
        lib_path = BUILD_DIR / f"lib{self.name}_{digest}.so"
        if lib_path.exists():
            return lib_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{self.build_log}")
        os.replace(tmp, lib_path)
        BUILDS[(self.name, "build")] += 1
        return lib_path

    def load(self) -> ctypes.CDLL:
        """The bound library (built on first call)."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            err = getattr(lib, f"{self.name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
            BUILDS[(self.name, "load")] += 1
        return self._lib

    def check(self, rc: int, what: str) -> None:
        """Raise if a launch returned a non-zero CUDA error code."""
        if rc != 0:
            text = getattr(self.load(), f"{self.name}_error_string")(rc)
            raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                               f"({text.decode()})")


def build_all(libraries) -> dict[str, float]:
    """Build several libraries at once, one nvcc process each; returns each
    library's build seconds by name (raises on the first failed build)."""
    def one(library):
        t0 = time.perf_counter()
        library.build()
        return library.name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(len(libraries), 1)) as pool:
        return dict(pool.map(one, libraries))

