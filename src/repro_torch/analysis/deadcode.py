"""Dead-export detection over the port's own sources (warn-level).

The port's copy of repro/analysis/deadcode.py. It collects every public
top-level symbol defined under ``src/repro_torch`` with `ast` and counts
identifier-token references to it across the port's own files:
``src/repro_torch``, ``tests/test_torch_*.py``, ``chip_smoke.py`` and
``examples/torch_*.py``. The reference's sources are left out on purpose:
every name the port shares with them would count as used. A symbol whose
name is never mentioned outside its defining statement is reported as a
warn finding — advisory only (string-based dispatch, __getattr__
re-exports and CLI entry points can all hide uses), so it never affects
the lint exit code. Suppress a finding by prefixing the name with ``_``,
deleting the symbol, or annotating the definition line with
``# lint: keep``.
"""

from __future__ import annotations

import ast
import io
import pathlib
import tokenize
from typing import Iterable

__all__ = ["collect_exports", "reference_counts", "dead_exports"]

PACKAGE = ("src", "repro_torch")
# (directory, glob) pairs of the port's own files
SOURCES = (("src/repro_torch", "**/*.py"), ("tests", "test_torch_*.py"),
           (".", "chip_smoke.py"), ("examples", "torch_*.py"))


def _py_files(root: pathlib.Path) -> list:
    files: list = []
    for d, pattern in SOURCES:
        base = root / d
        if base.is_dir():
            files.extend(sorted(base.glob(pattern)))
    return files


def collect_exports(root) -> dict:
    """{symbol: defining files} for every public module-level def/class/
    assignment under src/repro_torch. Later definitions of a shared name
    keep every site (a name defined twice is 'used' if referenced
    anywhere)."""
    root = pathlib.Path(root)
    exports: dict = {}
    for path in sorted(root.joinpath(*PACKAGE).rglob("*.py")):
        text = path.read_text()
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError:
            continue
        lines = text.splitlines()
        for node in tree.body:
            if "lint: keep" in lines[node.lineno - 1]:
                continue
            names: list = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, ast.Assign):
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name) and node.value is not None:
                    names = [node.target.id]
            for name in names:
                if name.startswith("_") or name == "__all__":
                    continue
                exports.setdefault(name, []).append(
                    str(path.relative_to(root)))
    return exports


def reference_counts(names: Iterable[str], files: Iterable) -> dict:
    """Identifier-token occurrence counts (NOT substring matches — `run`
    inside `run_rules` does not count) for each name across the files."""
    wanted = set(names)
    counts = {n: 0 for n in wanted}
    for path in files:
        try:
            text = pathlib.Path(path).read_text()
        except OSError:
            continue
        try:
            toks = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in toks:
                if tok.type == tokenize.NAME and tok.string in wanted:
                    counts[tok.string] += 1
        except tokenize.TokenizeError:
            continue
    return counts


def dead_exports(root) -> list:
    """[(symbol, defining_files)] for public exports referenced nowhere
    beyond their own definition line(s)."""
    root = pathlib.Path(root)
    exports = collect_exports(root)
    counts = reference_counts(exports, _py_files(root))
    # each definition statement mentions the name exactly once; any
    # additional token anywhere (an import, a call, a test) is a use
    return [(name, files) for name, files in sorted(exports.items())
            if counts.get(name, 0) <= len(files)]
