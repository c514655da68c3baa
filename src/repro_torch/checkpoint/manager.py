"""Checkpoint/restart with async save (port of
`repro.checkpoint.manager`, on-disk format shared with it).

  * Each save writes `step_XXXXXXXX/` holding `arrays.npz` (one array per
    leaf, keys a0, a1, ...) and `manifest.json` with the step and, per
    leaf, its name (`common.pytree.named_leaves`, the reference's
    spelling and order), shape, dtype and the sha1 of its bytes, so a
    torn or corrupted write is detected at restore.
  * Saves run on a background thread off the step's critical path, after
    a snapshot to host memory; the train loop only blocks if a previous
    save is still in flight (double-buffer). A save is published by an
    atomic rename of its temporary directory.
  * `keep` rotation bounds disk usage; `latest_step()` drives restart.

Arrays are saved whole, so a float32 train state written by either
package restores into the other. bfloat16 leaves (which numpy has no type
for) are stored as their 16-bit patterns with the dtype "bfloat16".
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.common.pytree import named_leaves


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, order="C"))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------ save
    def save(self, step: int, state, blocking: bool = False):
        """Snapshot to host memory, then write asynchronously."""
        self.wait()  # at most one save in flight
        host = [(name, _to_numpy(leaf), str(torch.as_tensor(leaf).dtype))
                for name, leaf in named_leaves(state)]
        self._pending = threading.Thread(target=self._write,
                                         args=(step, host), daemon=True)
        self._pending.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host):
        tmp = os.path.join(self.directory,
                           f".tmp_step_{step}_{time.time_ns()}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        arrays = {}
        for i, (name, arr, tdtype) in enumerate(host):
            key = f"a{i}"
            arrays[key] = arr
            manifest["leaves"].append({
                "name": name,
                "key": key,
                "shape": list(arr.shape),
                "dtype": ("bfloat16" if tdtype == "torch.bfloat16"
                          else str(arr.dtype)),
                "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
            })
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._rotate()

    def _rotate(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target, verify: bool = True, device=None):
        """Restore into the structure of `target` (a tree of tensors, meta
        tensors included): each leaf with the file's dtype, on `device`,
        or else on the target leaf's device. Raises IOError on a checksum
        mismatch (with `verify`) and KeyError on a missing leaf."""
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for entry in manifest["leaves"]:
                arr = data[entry["key"]]
                if verify and hashlib.sha1(arr.tobytes()).hexdigest() \
                        != entry["sha1"]:
                    raise IOError(f"checksum mismatch in {entry['name']} "
                                  f"at step {step}")
                by_name[entry["name"]] = (arr, entry["dtype"])
        names = [n for n, _ in named_leaves(target)]
        missing = [n for n in names if n not in by_name]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        it = iter(names)

        def put(leaf):
            arr, dtype = by_name[next(it)]
            return _from_numpy(arr, dtype, device or leaf.device)

        return _rebuild(target, put)


def _rebuild(tree, put):
    """`put` over the leaves of nested dicts in `named_leaves` order
    (sorted keys), keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], put) for k in sorted(tree)}
    return put(tree)
