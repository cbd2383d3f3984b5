"""Checkpoint store: atomic, resumable checkpoints on the reference's
on-disk layout (the port of ``repro.checkpoint.store``).

Layout:  <dir>/step_<N>/{manifest.json, <leaf>.npy..., COMMIT}

  * atomic commit: leaves are written into step_<N>.tmp, then a COMMIT
    marker and a rename make the step visible, so a crash mid-save never
    corrupts the latest checkpoint;
  * only directories named step_<digits> with a COMMIT count as
    checkpoints: a step_<N>.tmp that holds its COMMIT but is not renamed yet
    is ignored (the reference parses "<N>.tmp" as a step there and fails);
  * the same leaf names as the reference (its ``_leaf_name``: the
    ``jax.tree_util.keystr`` of the leaf's path, ['key'] for a dict key and
    [i] for a list index, runs of other characters than [a-zA-Z0-9_.-]
    replaced by "_", stripped, 180 characters at most) and bf16 saved as its
    uint16 view with "bfloat16" in the manifest. Trees are saved in the
    reference's nesting (``models.bridge.to_reference_layout``), so a
    checkpoint written by either package restores in the other;
  * async save: a background thread serializes while training continues
    (the tensors are copied to the host first); keep-N garbage collection.

Leaves are torch tensors or numpy arrays. ``restore`` loads every leaf of a
target tree by its name and gives it the target leaf's dtype, on the target
leaf's device or on ``device``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves_with_path, tree_map

_LEAF_RX = re.compile(r"[^a-zA-Z0-9_.-]+")
_STEP_RX = re.compile(r"step_(\d+)")


def _leaf_name(path) -> str:
    keystr = "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)
    return _LEAF_RX.sub("_", keystr).strip("_")[:180]


def _named_leaves(tree):
    pairs = tree_leaves_with_path(tree)
    names = [_leaf_name(p) for p, _ in pairs]
    assert len(set(names)) == len(names), "leaf name collision"
    return names, [v for _, v in pairs]


class _HostLeaf:
    """A leaf copied to the host: numpy (bf16 as its uint16 bits) and the
    logical dtype name the manifest keeps."""

    def __init__(self, arr: np.ndarray, logical: str):
        self.arr, self.logical = arr, logical


def _to_host(leaf) -> np.ndarray:
    """A leaf as numpy on the host; bf16 as its uint16 bits (the manifest
    keeps "bfloat16")."""
    if isinstance(leaf, _HostLeaf):
        return leaf.arr
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _logical(leaf) -> str:
    if isinstance(leaf, _HostLeaf):
        return leaf.logical
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).split(".")[1]
    return str(np.asarray(leaf).dtype)


def save(ckpt_dir, step: int, tree: Any) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names, leaves = _named_leaves(tree)
    manifest = {"step": step, "leaves": []}
    for name, leaf in zip(names, leaves):
        logical = _logical(leaf)
        arr = _to_host(leaf)
        if logical == "bfloat16" and arr.dtype != np.uint16:  # ml_dtypes' bf16 from numpy
            arr = arr.view(np.uint16)
        np.save(tmp / f"{name}.npy", arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape), "dtype": logical})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _committed_steps(ckpt_dir: Path):
    if not ckpt_dir.exists():
        return []
    steps = []
    for d in ckpt_dir.iterdir():
        m = _STEP_RX.fullmatch(d.name)
        if m and d.is_dir() and (d / "COMMIT").exists():
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = _committed_steps(Path(ckpt_dir))
    return steps[-1] if steps else None


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64, "int32": torch.int32,
                 "int64": torch.int64, "int8": torch.int8, "uint8": torch.uint8,
                 "int16": torch.int16, "bool": torch.bool, "float16": torch.float16}


def _from_host(arr: np.ndarray, logical: str) -> torch.Tensor:
    flat = np.ascontiguousarray(arr).reshape(-1)
    if logical == "bfloat16":
        t = torch.from_numpy(flat.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(flat).to(_TORCH_DTYPES[logical])
    return t.reshape(arr.shape)


def restore(ckpt_dir, step: int, target: Any, device=None) -> Any:
    """Load ``step`` into the structure of ``target`` (leaves: tensors, on
    any device, ``meta`` included): each leaf by its name, cast to the target
    leaf's dtype and moved to ``device`` (default: the target leaf's)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    manifest = {l["name"]: l for l in json.loads((d / "manifest.json").read_text())["leaves"]}
    names, _ = _named_leaves(target)
    it = iter(names)

    def load(tgt):
        name = next(it)
        arr = np.load(d / f"{name}.npy")
        t = _from_host(arr, manifest.get(name, {}).get("dtype", str(arr.dtype)))
        return t.to(device=device if device is not None else tgt.device, dtype=tgt.dtype)

    return tree_map(load, target)


class CheckpointManager:
    """Async save + keep-N retention + resume discovery."""

    def __init__(self, ckpt_dir, keep: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _do_save(self, step, host_tree):
        try:
            save(self.dir, step, host_tree)
            self._gc()
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def save(self, step: int, tree: Any):
        """Copy ``tree`` to the host now (numpy, bf16 as uint16 with its
        logical dtype kept) and write it on a thread (or here without
        ``async_save``)."""
        self.wait()
        host_tree = tree_map(lambda x: _HostLeaf(_to_host(x), _logical(x)), tree)
        if self.async_save:
            self._thread = threading.Thread(target=self._do_save, args=(step, host_tree))
            self._thread.start()
        else:
            self._do_save(step, host_tree)

    def _gc(self):
        for s in _committed_steps(self.dir)[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore(self, step: int, target: Any, device=None) -> Any:
        return restore(self.dir, step, target, device=device)

