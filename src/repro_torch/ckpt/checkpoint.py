"""Fault-tolerant checkpointing: atomic, versioned, keep-last-k, resumable.

Twin of repro/ckpt/checkpoint.py, with the same on-disk format, so a
checkpoint written by either package restores into the other:

  * every checkpoint is a directory  step_<10 digits>/  with one
    leaf_<5 digits>.npy per leaf plus a manifest.json holding `step`,
    `extra` and `leaves[{path, file, shape, dtype}]`
  * writes go to  step_<n>.tmp/  and are os.rename'd — a crash mid-write
    can never corrupt the latest checkpoint (restart-safe)
  * restore_latest scans for the highest complete manifest — a half-written
    directory from a killed process is ignored and garbage-collected
  * leaves are saved as host arrays; bf16 (which NumPy cannot hold) is
    widened to f32 on disk and the manifest keeps the original dtype

Leaf order and path strings are JAX's pytree flattening, which the files
of both packages must share: dict keys sorted (a GAT layer is `a_dst,
a_src, b, w, w_out`), list items by index, NamedTuple fields in
declaration order with a leading dot (`opt_state/.mu/layers/0/a_dst`),
None holding no leaf. The reference's `shardings` argument (re-placing
leaves on a new JAX mesh) has no counterpart: every leaf is restored onto
its target tensor's device and dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten_with_paths(tree: Any, prefix: str = "", out=None) -> list:
    """[(path, leaf)] in JAX's flattening order (see the module docstring)."""
    out = [] if out is None else out

    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if tree is None:
        return out
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten_with_paths(tree[key], join(str(key)), out)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            _flatten_with_paths(getattr(tree, name), join("." + name), out)
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            _flatten_with_paths(item, join(str(i)), out)
    else:
        out.append((prefix, tree))
    return out


def _unflatten(tree: Any, leaves) -> Any:
    """`tree`'s structure with its leaves taken, in flattening order, from
    the iterator `leaves`; dicts keep their key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
        return {key: new[key] for key in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_unflatten(getattr(tree, name), leaves)
                            for name in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, leaves) for item in tree)
    return next(leaves)


def _host_array(leaf: Any) -> tuple[np.ndarray, str]:
    """(the leaf as a NumPy array NumPy can save, its original dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        try:
            return t.numpy(), name
        except TypeError:  # bf16 / fp8: widen to f32, keep the name
            return t.to(torch.float32).numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V" or "bfloat16" in name:
        arr = arr.astype(np.float32)
    return arr, name


def _shape(leaf: Any) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def tree_nbytes(tree: Any) -> int:
    """The bytes of `tree`'s tensor leaves: what a checkpoint of it holds
    (bf16 leaves at their own width, before the widening on disk)."""
    def nbytes(leaf) -> int:
        if isinstance(leaf, torch.Tensor):
            return leaf.numel() * leaf.element_size()
        return np.asarray(leaf).nbytes

    return sum(nbytes(leaf) for _, leaf in _flatten_with_paths(tree))


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomically write `tree` as checkpoint `step` under `directory`."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": [],
    }
    for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, orig_dtype = _host_array(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape),
             "dtype": orig_dtype}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _complete_checkpoints(directory: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if name.endswith(".tmp"):
            continue
        if name.startswith("step_") and os.path.exists(
            os.path.join(full, "manifest.json")
        ):
            try:
                step = int(name[5:])
            except ValueError:
                # a stray directory (step_final/, step_backup/, ...) must not
                # kill restore — skip it loudly instead
                warnings.warn(
                    f"ignoring non-checkpoint entry {name!r} in {directory!r}"
                    " (step_<n> suffix is not an integer)",
                    stacklevel=2)
                continue
            out.append((step, full))
    return sorted(out)


def _place(arr: np.ndarray, leaf: Any) -> Any:
    """`arr` on the target leaf's device and in its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    target_dtype = getattr(leaf, "dtype", None)
    return arr.astype(target_dtype) if target_dtype is not None else arr


def restore_latest(directory: str,
                   target_tree: Any) -> tuple[Optional[int], Any]:
    """Restore the newest complete checkpoint into target_tree's structure,
    each leaf on its target's device and in its dtype.
    Returns (step or None, tree)."""
    ckpts = _complete_checkpoints(directory)
    if not ckpts:
        return None, target_tree
    step, path = ckpts[-1]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten_with_paths(target_tree)
    assert len(flat) == len(manifest["leaves"]), (
        f"checkpoint has {len(manifest['leaves'])} leaves, "
        f"target tree has {len(flat)}"
    )
    # the zip below is positional — guard it: a target tree with the same
    # leaf count but different structure must fail by NAME, not by silently
    # loading leaf i into the wrong slot (or by a shape assert if lucky)
    for (path_t, _), rec in zip(flat, manifest["leaves"]):
        if path_t != rec["path"]:
            raise ValueError(
                f"checkpoint/target tree mismatch at leaf {rec['path']!r}: "
                f"target tree has {path_t!r} in that position")
    new_leaves = []
    for (_, leaf), rec in zip(flat, manifest["leaves"]):
        arr = np.load(os.path.join(path, rec["file"]))
        assert tuple(arr.shape) == _shape(leaf), (
            rec["path"], arr.shape, _shape(leaf)
        )
        new_leaves.append(_place(arr, leaf))
    return step, _unflatten(target_tree, iter(new_leaves))


def checkpoint_extra(directory: str) -> tuple[Optional[int], dict]:
    """The (step, extra-metadata) of the newest complete checkpoint, read
    without touching any leaf file — resume logic needs the run coordinates
    (epoch, step, has_ef) BEFORE it can build the target tree to restore
    into. Returns (None, {}) when no checkpoint exists."""
    ckpts = _complete_checkpoints(directory)
    if not ckpts:
        return None, {}
    step, path = ckpts[-1]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return step, manifest.get("extra", {}) or {}


class CheckpointManager:
    """Keep-last-k manager with garbage collection of stale/partial dirs."""

    def __init__(self, directory: str, keep: int = 3, every: int = 50):
        self.directory = directory
        self.keep = keep
        self.every = every
        os.makedirs(directory, exist_ok=True)
        self._gc_partial()

    def _gc_partial(self) -> None:
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def maybe_save(self, step: int, tree: Any, extra: Optional[dict] = None,
                   force: bool = False) -> Optional[str]:
        if not force and (step % self.every) != 0:
            return None
        path = save_checkpoint(self.directory, step, tree, extra)
        self._gc_old()
        return path

    def _gc_old(self) -> None:
        ckpts = _complete_checkpoints(self.directory)
        for _, path in ckpts[: -self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    def restore(self, target_tree: Any):
        return restore_latest(self.directory, target_tree)
