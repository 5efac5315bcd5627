"""Atomic, async checkpointing (tensorstore-free), with the reference's
on-disk layout, so a checkpoint written by either package restores in the
other.

Twin of the reference's ``checkpoint/checkpointer.py``.  Layout per step:

    <dir>/step_<N>.tmp/          (written first)
        arrays.npz               the leaves, key ``a{i}`` in JAX's flatten
                                 order (a dict's keys sorted)
        manifest.json            step, wall time, each leaf's key (its path
                                 joined by "/"), idx, shape and dtype
    <dir>/step_<N>/              (atomic rename = commit)

Fault-tolerance contract (``runtime/fault_tolerance.py`` builds on this):

* a checkpoint is valid iff its manifest is present in a committed dir --
  a crash mid-write leaves only a .tmp dir, which restore ignores and
  :meth:`Checkpointer.cleanup_tmp` deletes;
* :meth:`Checkpointer.restore_latest` walks committed steps newest-first
  and falls back if a dir is unreadable (torn disk), so a corrupted newest
  checkpoint costs one interval, never the run;
* :meth:`Checkpointer.save` copies every leaf to host memory before it
  returns (the caller may update its tensors in place right after); the
  async path then writes on a worker thread whose error surfaces at the
  next :meth:`Checkpointer.wait`;
* restore reads every leaf and checks the count and shapes before it
  writes any, then copies them into ``like``'s tensors, in place, on their
  devices and in their dtypes.

A bf16 leaf is stored as the reference stores one: numpy has no bfloat16
without ``ml_dtypes``, so the reference's ``np.savez`` writes its two raw
bytes (numpy dtype ``V2``), and the manifest says ``bfloat16``.  Plain
numpy reads those bytes back, and the port restores them as bf16 (the
reference cannot restore such a leaf at all).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, unflatten_like


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that no later in-place update can reach."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    leaf = leaf.detach().to("cpu", copy=True)
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _from_disk(arr: np.ndarray, dtype: str, key: str) -> torch.Tensor:
    arr = np.array(arr, order="C")   # keeps a 0-d leaf 0-d
    if dtype == "bfloat16" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise ValueError(f"leaf {key!r}: {dtype} stored as raw bytes ({arr.dtype}), which "
                         "this restore cannot read")
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # -- write ------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = True) -> None:
        flat = [(_key(path), _to_host(leaf), _dtype_name(leaf))
                for path, leaf in flatten_with_path(tree)]
        if blocking:
            self._write(step, flat)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_safe, args=(step, flat), daemon=True
            )
            self._thread.start()

    def _write_safe(self, step: int, flat) -> None:
        try:
            self._write(step, flat)
        except BaseException as e:  # surfaced on next wait()
            self._last_error = e

    def _write(self, step: int, flat) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": arr for i, (_, arr, _) in enumerate(flat)})
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": [
                {"key": k, "idx": i, "shape": list(arr.shape), "dtype": dtype}
                for i, (k, arr, dtype) in enumerate(flat)
            ],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # commit point
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.committed_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- read -------------------------------------------------------------

    def committed_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like):
        """Restore into ``like``, a tree of tensors: they are overwritten in
        place, keeping their devices and dtypes, and returned in ``like``'s
        structure."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = flatten_with_path(like)
        if len(manifest["leaves"]) != len(flat_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, target {len(flat_like)}"
            )
        with np.load(os.path.join(d, "arrays.npz")) as data:
            loaded = [_from_disk(data[f"a{i}"], m["dtype"], m["key"])
                      for i, m in enumerate(manifest["leaves"])]
        for (path, fl), t in zip(flat_like, loaded):
            if tuple(fl.shape) != tuple(t.shape):
                raise ValueError(f"leaf {_key(path)!r}: checkpoint shape {tuple(t.shape)}, "
                                 f"target {tuple(fl.shape)}")
        with torch.no_grad():
            return unflatten_like(like, [fl.copy_(t) for (_, fl), t in zip(flat_like, loaded)])

    def restore_latest(self, like):
        """(step, tree) from the newest readable checkpoint, or (None, None)."""
        for step in reversed(self.committed_steps()):
            try:
                return step, self.restore(step, like)
            except Exception:
                continue  # torn checkpoint: fall back to the previous one
        return None, None

    def cleanup_tmp(self) -> int:
        n = 0
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
                n += 1
        return n
