"""Fault-tolerant checkpointing: atomic, versioned, checksummed, async; the
port of the JAX package's ``repro/train/checkpoint.py``, with its on-disk
layout.

  * atomic publish -- write to ``step_XXXXXXXXXX.tmp/``, fsync, rename; a
    crash mid-save never corrupts the newest visible checkpoint;
  * content checksums -- every leaf's sha256 (its first 16 hex digits) is
    in ``manifest.json`` and checked on restore; a corrupt checkpoint
    falls back to the one before (``restore_with_retry``);
  * async save -- the tree is copied to host memory at once and written
    by one background thread; its error is raised at ``wait()``;
  * device independence -- leaves are saved whole, so a restore works on
    any device (``train/elastic.reshard``).

A tree is nested dicts (and lists or tuples) of tensors or arrays; a
leaf's path joins its keys with dots (``params.layers.0.mixer.wq``), as the
JAX package's ``path_str`` does, and leaves are numbered in sorted-key
order, as ``jax.tree_util`` flattens a dict.  ``arrays.npz`` holds them as
``leaf_00000``, ...
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch


def _leaves(tree, prefix=""):
    """[(path, leaf)] in sorted-key order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, x in items:
        out += _leaves(x, f"{prefix}.{k}" if prefix else k)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return next(it)


def _host_copy(x) -> np.ndarray:
    """A host copy that shares no memory with ``x``: ``Tensor.numpy()``
    and ``np.asarray`` alias a CPU tensor or array, and a later in-place
    update would reach the checkpoint being written."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = os.fspath(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None,
             async_: bool = False):
        """Copy to host memory now; write atomically (in the background
        with ``async_``)."""
        leaves = [(p, _host_copy(x)) for p, x in _leaves(tree)]
        if async_:
            self.wait()                      # one save in flight at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, leaves, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, leaves, extra: dict):
        try:
            tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
            final = os.path.join(self.dir, f"step_{step:010d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "extra": extra, "leaves": {}}
            arrays = {}
            for i, (path, arr) in enumerate(leaves):
                key = f"leaf_{i:05d}"
                arrays[key] = arr
                manifest["leaves"][key] = {
                    "path": path, "shape": list(arr.shape),
                    "dtype": str(arr.dtype), "sha": _sha(arr)}
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)           # atomic publish
            self._gc()
        except Exception as e:  # raised at the next wait()
            self._error = e

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, tree_like, strict_checksum: bool = True):
        """Restore into the structure of ``tree_like`` (shapes must match):
        host tensors in each reference leaf's dtype.  Returns (tree,
        extra)."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for key, meta in manifest["leaves"].items():
                arr = data[key]
                if strict_checksum and _sha(arr) != meta["sha"]:
                    raise IOError(f"checksum mismatch in {d}: "
                                  f"{meta['path']}")
                by_path[meta["path"]] = arr
        out = []
        for ps, ref in _leaves(tree_like):
            if ps not in by_path:
                raise KeyError(f"checkpoint missing leaf {ps}")
            arr = by_path[ps]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {ps}: ckpt "
                                 f"{arr.shape} vs model {tuple(ref.shape)}")
            t = torch.from_numpy(arr)
            out.append(t.to(ref.dtype) if isinstance(ref, torch.Tensor)
                       else arr.astype(ref.dtype))
        return _rebuild(tree_like, iter(out)), manifest["extra"]

    def restore_with_retry(self, tree_like):
        """Restore the newest valid checkpoint, falling back across corrupt
        versions.  Returns (step, tree, extra) or None."""
        for step in reversed(self.all_steps()):
            try:
                tree, extra = self.restore(step, tree_like)
                return step, tree, extra
            except Exception:
                continue
        return None
