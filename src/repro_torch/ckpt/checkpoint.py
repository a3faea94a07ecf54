"""Atomic, asynchronous checkpoints (counterpart of the JAX package's
``ckpt/checkpoint.py``), in its on-disk format.

Layout (one directory per step)::

    <dir>/step_000000123/
        manifest.json     step, creation time, tree structure, and per
                          leaf its key, shape, logical dtype and file
        arr_00000.npy ... one file per leaf, in the tree's leaf order
        _COMMITTED        written last: readers ignore a dir without it

Keys are ``jax.tree_util.keystr`` paths over the port's tree
(``['params']['layers'][0]['attn']['wq']``, ``['opt'].step``), leaves
in sorted-key order; bf16 leaves are stored as ``uint16`` views with
``bfloat16`` in the manifest, so a flat tree written by either package
reads back in the other.

* atomic: a ``.tmp`` directory, renamed, then the commit marker, so a
  writer stopped midway never spoils the latest checkpoint;
* async: ``save(..., blocking=False)`` copies every leaf to host memory
  first (the next step updates the parameters in place, and on the CPU
  ``Tensor.numpy()`` would share their storage), then writes on a
  background thread; one save is in flight at a time;
* self-pruning: ``keep_last`` bounds the disk used;
* ``restore`` loads into a template's structure, dtypes and device (or
  ``device``), and raises on a missing leaf or a shape mismatch.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import (flatten_with_paths, map_with_paths,
                                    treedef_str)

_COMMIT = "_COMMITTED"


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy of ``leaf`` as numpy, its logical dtype): bf16 as a
    ``uint16`` view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, logical: str) -> torch.Tensor:
    if "bfloat16" in logical:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, clock=None):
        """``clock`` is the injectable wall clock (seconds) that stamps the
        manifest's ``created`` field and the commit marker; ``None``
        means ``time.time``."""
        self.dir = directory
        self.keep_last = keep_last
        self.clock = clock
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def now_s(self) -> float:
        return time.time() if self.clock is None else float(self.clock())

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = True,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot ``tree`` (tensors, numpy arrays or scalars) at
        ``step``."""
        self.wait()                       # one async save in flight at a time
        host = []
        logical = []
        for k, v in flatten_with_paths(tree):
            a, dt = _to_host(v)
            host.append((k, a))
            logical.append(dt)
        manifest = {
            "step": int(step),
            "created": self.now_s(),
            "treedef": treedef_str(tree),
            "leaves": [{"key": k, "shape": list(a.shape),
                        "dtype": logical[i], "file": f"arr_{i:05d}.npy"}
                       for i, (k, a) in enumerate(host)],
            "extra": extra or {},
        }

        def write():
            final = os.path.join(self.dir, f"step_{step:09d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for i, (_, a) in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, _COMMIT), "w") as f:
                f.write(str(self.now_s()))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._prune()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(full, _COMMIT)):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                device=None) -> Tuple[Any, int]:
        """Load ``step`` (default: the latest committed) into the
        structure of ``template``: each leaf in the template leaf's dtype,
        on ``device`` (default: the template leaf's device; numpy leaves
        stay numpy)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}

        def load(key, leaf):
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            e = by_key[key]
            arr = np.load(os.path.join(d, e["file"]))
            if not isinstance(leaf, torch.Tensor):
                if "bfloat16" in e["dtype"]:
                    raise TypeError(f"{key}: a bf16 leaf restores into a "
                                    "tensor template")
                out = arr.astype(np.asarray(leaf).dtype)
            else:
                out = _from_host(arr, e["dtype"]).to(leaf.dtype)
            want = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                         else np.shape(leaf))
            if tuple(out.shape) != want:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(out.shape)} vs template {want}")
            if isinstance(leaf, torch.Tensor):
                out = out.to(leaf.device if device is None else device)
            return out

        return map_with_paths(load, template), step
