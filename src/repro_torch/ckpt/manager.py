"""Checkpoint manager: async save, atomic publish, retention, restore onto a
device — the fault-tolerance substrate.

Layout per step (the reference's):
    <dir>/step_<N>.tmp/       (written)
    <dir>/step_<N>/           (atomic rename on completion)
        manifest.json         (step, time, and each leaf's file, shape, dtype)
        arr_<i>.npy           (one file per leaf)

Leaves are taken in ``repro_torch.tree``'s order (dict entries by sorted key,
lists, tuples and NamedTuples by position; a ``None`` subtree holds no leaf
and is kept as it is). A leaf is a tensor on any device or a numpy array.
numpy has no bfloat16 here, so a bf16 leaf is written as its ``uint16`` bits
with ``"dtype": "bfloat16"`` in the manifest and read back bit for bit.

Restore loads each leaf on the host, checks it against the target's leaf
(count, shape and dtype must match) and puts it on ``device`` (by default the
target leaf's own device), with the target leaf's ``requires_grad``.

Sharded state (``DTensor`` leaves, the sharded trainer's): ``save`` gathers
each leaf's full tensor, so every rank of its mesh must call it, and only the
manager made with ``writer=True`` (rank 0) writes; ``restore`` places each
full array onto the target leaf's mesh and placements, each rank keeping its
shards (the reference's ``restore(..., shardings=)``): a checkpoint saved on
one mesh restores onto another.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
                 "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _to_host(leaf):
    """(numpy array to write, dtype name for the manifest), copied now."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _DTYPE_NAMES[t.dtype]
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _DTYPE_NAMES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 async_save: bool = True, writer: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.writer = writer
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: Optional[bool] = None):
        """Snapshot to host memory synchronously, write to disk (async by
        default so training continues during I/O)."""
        self.wait()                              # one outstanding save max
        host = []
        for x in tree.leaves(state):             # device->host now
            if isinstance(x, DTensor):
                x = x.full_tensor()              # every rank of the mesh gathers
            if self.writer:
                host.append(_to_host(x))
        if not self.writer:
            return
        if blocking is None:
            blocking = not self.async_save
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host), daemon=True)
            self._thread.start()

    def _write_guarded(self, step, host):
        try:
            self._write(step, host)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def _write(self, step: int, host):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for i, (a, dtype) in enumerate(host):
            np.save(tmp / f"arr_{i}.npy", a)
            manifest["leaves"].append(
                {"file": f"arr_{i}.npy", "shape": list(a.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                         # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {e}") from e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue            # incomplete save: never published
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, *, device=None):
        """Load into the structure of ``target`` (tensors or numpy arrays).

        Leaf count, shapes and dtypes are checked against the manifest. Each
        tensor leaf lands on ``device``, or where the target's leaf lies."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        t_leaves = tree.leaves(target)
        if len(manifest["leaves"]) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, target "
                f"has {len(t_leaves)} — incompatible structure")
        out = []
        for meta, t in zip(manifest["leaves"], t_leaves):
            a = np.load(d / meta["file"])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{meta['file']}: shape mismatch {a.shape} vs {tuple(t.shape)}")
            if meta["dtype"] != _dtype_name(t):
                raise ValueError(f"{meta['file']}: dtype mismatch {meta['dtype']} "
                                 f"vs {_dtype_name(t)}")
            if not isinstance(t, torch.Tensor):
                out.append(a)
                continue
            if meta["dtype"] == "bfloat16":
                x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                x = torch.from_numpy(a)
            x = x.to(device if device is not None else t.device)
            if isinstance(t, DTensor):
                x = distribute_tensor(x, t.device_mesh, t.placements, src_data_rank=None)
            out.append(x.requires_grad_(t.requires_grad))
        return tree.rebuild(target, out)

    def restore_latest(self, target, *, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, device=device)
