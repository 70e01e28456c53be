"""Checkpoint manager: async save, atomic publish, retention, restore onto a
device — the fault-tolerance substrate.

Layout per step (the reference's):
    <dir>/step_<N>.tmp/       (written)
    <dir>/step_<N>/           (atomic rename on completion)
        manifest.json         (step, time, and each leaf's file, shape, dtype)
        arr_<i>.npy           (one file per leaf)

The port writes its own leaf order: ``repro_torch.tree``'s (dict entries by
sorted key, lists, tuples and NamedTuples by position; a ``None`` subtree holds
no leaf and is kept as it is), one leaf a layer. A leaf is a tensor on any
device or a numpy array. numpy has no bfloat16 here, so a bf16 leaf is written
as its ``uint16`` bits with ``"dtype": "bfloat16"`` in the manifest and read
back bit for bit.

``restore`` loads each leaf on the host, checks it against the target's leaf
(count, shape and dtype must match) and puts it on ``device`` (by default the
target leaf's own device), with the target leaf's ``requires_grad``.

A step may also be in a second layout of the same target that the caller
gives (``stacked``): for a train state, the JAX package's manager's
(``compat.jax_layout``), which stacks each layer's leaves on leading dims and
orders the leaves as ``jax.tree_util`` does. ``layout`` names the one whose
every leaf count, shape and dtype name the step's manifest matches; the two
cannot both match, since a stacked leaf has one more dim than a layer's, and a
step that matches neither raises. Such a step is read one stacked array at a
time. A bf16 leaf of the JAX manager (saved through ``ml_dtypes``, a 2-byte
void type to a numpy without it) is read through its ``uint16`` view. The port
still writes only its own layout, so a directory that resumed a JAX step and
saved again holds both; each step is read by its own manifest, and retention
counts the steps of either.

Sharded state (``DTensor`` leaves, the sharded trainer's): ``save`` gathers
each leaf's full tensor, so every rank of its mesh must call it, and only the
manager made with ``writer=True`` (rank 0) writes; a restore places each
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


def _placed(a, dtype: str, t, device):
    """The host array ``a`` (manifest dtype ``dtype``) as a tensor like the
    target leaf ``t``: on ``device`` or ``t``'s, on ``t``'s mesh and placements
    if ``t`` is a ``DTensor``, with ``t``'s ``requires_grad``."""
    if dtype == "bfloat16":
        x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        x = torch.from_numpy(a)
    x = x.to(device if device is not None else t.device)
    if isinstance(t, DTensor):
        x = distribute_tensor(x, t.device_mesh, t.placements, src_data_rank=None)
    return x.requires_grad_(t.requires_grad)


def _mismatch(manifest, want) -> Optional[str]:
    """``None`` where the manifest's leaves match ``want`` ([(path, shape,
    dtype name)]) in count, shape and dtype name; else what differs, the first
    differing leaf first."""
    out = []
    for i, (meta, (path, shape, dtype)) in enumerate(zip(manifest, want)):
        if tuple(meta["shape"]) != tuple(shape):
            what, a, b = "shape", tuple(meta["shape"]), tuple(shape)
        elif meta["dtype"] != dtype:
            what, a, b = "dtype", meta["dtype"], dtype
        else:
            continue
        out.append(f"leaf {i} {'/'.join(map(str, path))} ({meta['file']}): {what} "
                   f"mismatch {a} vs {b}")
        break
    if len(manifest) != len(want):
        out.append(f"checkpoint has {len(manifest)} leaves, target has {len(want)} "
                   "— incompatible structure")
    return "; ".join(out) or None


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

    def _manifest(self, step: int):
        return json.loads((self.dir / f"step_{step}" / "manifest.json").read_text())["leaves"]

    def layout(self, step: int, target: Any, stacked=None) -> str:
        """The layout step ``step`` was written in for ``target``: ``"port"``
        where its manifest matches ``target``'s own leaves, ``"jax"`` where it
        matches ``stacked`` (``restore``); ``ValueError`` naming what differs
        from each, first leaf first, where it matches neither."""
        manifest = self._manifest(step)
        own = _mismatch(manifest, [(p, tuple(t.shape), _dtype_name(t))
                                   for p, t in tree.leaves_with_paths(target)])
        if own is None:
            return "port"
        if stacked is None:
            raise ValueError(f"step_{step}: {own}")
        other = _mismatch(manifest, [(p, x.shape, _DTYPE_NAMES[x.dtype]) for p, x in stacked])
        if other is None:
            return "jax"
        raise ValueError(f"step_{step} matches neither layout of the target: the port's "
                         f"({own}); the JAX package's ({other})")

    def restore(self, step: int, target: Any, *, device=None, stacked=None):
        """Load into the structure of ``target`` (tensors or numpy arrays).

        Leaf count, shapes and dtypes are checked against the manifest. Each
        tensor leaf lands on ``device``, or where the target's leaf lies.
        ``stacked`` is a second layout of ``target`` that the step may be in:
        ``[(path, leaf)]`` in file order, each ``leaf`` with the ``shape`` and
        torch ``dtype`` of one array and ``parts``, the positions in
        ``tree.leaves(target)`` of the leaves it stacks on its leading dims
        (``compat.jax_layout``). Such a step's arrays are read one at a time,
        each cut into ``target``'s leaves."""
        d = self.dir / f"step_{step}"
        manifest = self._manifest(step)
        t_leaves = tree.leaves(target)
        if self.layout(step, target, stacked) == "port":
            out = []
            for meta, t in zip(manifest, t_leaves):
                a = np.load(d / meta["file"])
                out.append(_placed(a, meta["dtype"], t, device)
                           if isinstance(t, torch.Tensor) else a)
            return tree.rebuild(target, out)
        out = [None] * len(t_leaves)
        for meta, (_, x) in zip(manifest, stacked):
            a = np.load(d / meta["file"])
            if meta["dtype"] == "bfloat16":
                a = a.view(np.uint16)
            layers = a.reshape((len(x.parts),) + tuple(t_leaves[x.parts[0]].shape))
            for j, i in enumerate(x.parts):
                out[i] = _placed(layers[j, ...], meta["dtype"], t_leaves[i], device)
            del a, layers                     # the host holds one stacked leaf
        return tree.rebuild(target, out)

    def restore_latest(self, target, *, device=None, stacked=None):
        """``(step, state)`` of the latest step (``restore``), or ``(None, None)``."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target, device=device, stacked=stacked)
