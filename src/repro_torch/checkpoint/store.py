"""Checkpoints with async save, atomic publish and retention.

Port of the JAX package's ``checkpoint/store.py`` with its on-disk layout
(one directory per step)::

    <dir>/step_000123/
        manifest.json          # tree structure, shapes, dtypes, step
        leaf_00000.npy ...     # one .npy per leaf
    <dir>/step_000123.tmp/     # staging; renamed atomically when complete

* **Async**: ``save()`` copies every leaf to the host (blocking only on
  that copy, so the caller may go on updating its tensors in place) and
  writes the files on a background thread.
* **Atomic**: a writer stages into ``.tmp`` and renames at the end, so a
  failure mid-save never corrupts the latest checkpoint; ``latest_step()``
  only sees complete directories.
* **Restore**: ``restore(like)`` puts every leaf on the device and dtype of
  the matching leaf of ``like`` (and on its mesh and placements where it
  is a ``DTensor``), or on the placements of ``shardings`` (the new mesh's
  ``partition.Sharding``s: the elastic restart onto another topology),
  and returns the step it read, so a caller never has to ask the directory
  again (the reference's loop does, and can then resume after a newer
  step than the state it holds).
* **Retention**: the ``keep`` most recent checkpoints are kept.
* **Sharded state**: ``save`` writes each ``DTensor`` leaf as its
  ``full_tensor()`` (every rank takes part in the gather; rank 0 writes),
  so the manifest and the ``.npy`` files are those of a one-device save,
  and a checkpoint restores onto any mesh or none.  With more than one
  rank, :meth:`CheckpointStore.wait` ends in a barrier: after it every rank
  sees the checkpoint published.

numpy has no bfloat16: a bfloat16 leaf is written as float32 (exact) and
cast back on restore.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch import partition

_STEP_RE = re.compile(r"^step_(\d+)$")


def _ranks() -> tuple:
    """(this process's rank, the number of ranks) of the default group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    """``leaf`` as a plain tensor: a DTensor's ``full_tensor()`` (a
    collective every rank joins)."""
    t = leaf.detach()
    return t.full_tensor() if partition.is_dtensor(t) else t


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place updates do not touch."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False):
        """Checkpoint ``tree`` (nested dicts, lists, tuples and named tuples
        of tensors) at ``step``: the leaves are copied to the host before
        this returns, the files written on the store's thread (on rank 0;
        every rank calls ``save``)."""
        leaves, spec = pytree.tree_flatten(tree)
        writer = _ranks()[0] == 0
        host = []
        for x in leaves:                          # d2h snapshot (blocking)
            t = _whole(x)
            if writer:
                host.append(_host(t))
        self.wait()                               # one in-flight save max

        def write():
            tmp = os.path.join(self.dir, f"step_{step:06d}.tmp")
            final = os.path.join(self.dir, f"step_{step:06d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, arr in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
            manifest = {
                "step": step,
                "treedef": str(spec),
                "n_leaves": len(host),
                "shapes": [list(a.shape) for a in host],
                "dtypes": [str(a.dtype) for a in host],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()
            return final

        if writer:
            self._pending = self._pool.submit(write)
        if blocking:
            self.wait()

    def wait(self):
        """Block until the save in flight is written; re-raises its error.
        With several ranks, every rank then waits for the others."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
        if _ranks()[1] > 1:
            dist.barrier()

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:06d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, int]:
        """Load a checkpoint (the latest complete one, or ``step``) into the
        structure of ``like``, each leaf on the device and in the dtype of
        ``like``'s, distributed to ``like``'s mesh and placements where it
        is a DTensor.  ``shardings``: a tree congruent with ``like`` of
        ``partition.Sharding``s (or None leaves) that overrides them: pass
        the NEW mesh's to restore onto another topology.  Returns (the
        tree, the step it was saved at)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:06d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like, spec = pytree.tree_flatten(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(f"checkpoint {path} has {manifest['n_leaves']} "
                             f"leaves, the template {len(leaves_like)}")
        if shardings is None:
            places = [partition.Sharding(t.device_mesh, tuple(t.placements))
                      if partition.is_dtensor(t) else None
                      for t in leaves_like]
        else:
            places = spec.flatten_up_to(shardings)
        out = []
        for i, (ref, place) in enumerate(zip(leaves_like, places)):
            arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, "
                                 f"template {tuple(ref.shape)}")
            t = torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
            out.append(t if place is None else partition.place(t, place))
        return pytree.tree_unflatten(out, spec), int(manifest["step"])
