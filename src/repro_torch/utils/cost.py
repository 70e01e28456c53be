"""Eager cost counter: FLOPs, bytes, collective wire bytes and peak memory of
one step, the counterpart of ``src/repro/utils/hlo.py``.

The reference walks the compiled HLO text; the port has no HLO, so
``CostCounter`` is a ``TorchDispatchMode`` that sees every aten op the step
runs (on any device, meta included) and counts:

  * ``flops`` -- matmul, bmm, addmm, baddbmm and convolution FLOPs with the
    formulas ``torch.utils.flop_counter`` registers: the dots and convolutions
    that ``hlo_cost`` counts (its ``flops`` and ``dot_flops`` are one number).
    A Python loop over layers is unrolled in eager mode, so no trip-count
    heuristic is needed.
  * ``bytes`` -- for every op that materialises a result, its operand bytes
    plus its result bytes; views, metadata ops, ``empty*``, ``detach`` and
    aliasing ops count nothing (the counterpart of ``_NO_BYTES``). These are
    NOT the reference's bytes: XLA counts post-fusion instructions, and an
    eager step has no fusion, so this is what the eager step moves, an upper
    bound on what a fused step would move.
  * ``instr_count`` -- the number of ops counted.
  * ``collectives`` -- wire bytes a device puts on the wire, with the
    reference's keys (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``, ``count_<kind>``, ``total``) and
    its formulas on the result bytes ``b`` over a group of ``g`` read from the
    op's own group: all-reduce ``2*b*(g-1)/g``, all-gather ``b*(g-1)/g``,
    reduce-scatter ``b*(g-1)``, all-to-all ``b*(g-1)/g``, permute ``b``.
  * ``peak_bytes`` -- the largest sum of live bytes of the storages the step
    created, tracked by storage and freed when its last reference goes (a
    caller adds its arguments' bytes).

A DTensor argument counts its local shard: the numbers are one device's.

``CostCounter.kernel(name, flops=, bytes=)`` is the region a hand-written
kernel's wrapper opens (through ``kernel(name, counts, *args)``, which finds
the active counter): it records the kernel once, and counts nothing that runs
beneath it (the plain version on the CPU, autograd of it in the backward).

``xla_cost_analysis`` has no counterpart: there is no compiler's own cost
analysis to normalise.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed import distributed_c10d as c10d
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten

_open = 0      # CostCounters entered and not yet left, in this process

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
# the dots and convolutions hlo_cost counts, with torch's registered formulas
_FLOP_OPS = {p: flop_counter.flop_registry[p] for p in (
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution, aten._convolution,
    aten.convolution_backward)}

# ops that move no data beside the views (``OpOverload.is_view``): allocations,
# a view without alias annotation, metadata and the collectives' wrappers
_NO_BYTES_NAMES = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "is_same_size", "_local_scalar_dense",
    "_wrap_tensor_autograd", "wait_tensor",
}

# op name -> collective kind; the group is read from the op's arguments
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (one device's share), any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes on one device (a DTensor's local shard's)."""
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor):
    try:
        return _local(t).untyped_storage()
    except (NotImplementedError, RuntimeError):      # a tensor without storage
        return None


def _no_bytes(func) -> bool:
    return func.is_view or func.__name__.split(".")[0] in _NO_BYTES_NAMES


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an in-place op that returns nothing writes (``_foreach_*_``)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out += _tensors(args[i] if i < len(args) else kwargs.get(a.name))
    return out


def _arg(func, args, kwargs, name):
    """The argument of ``func`` called ``name`` in its schema, or ``None``."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else kwargs.get(name)
    return None


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over: a functional op
    names it (``group_name``), a c10d op passes it (``process_group``)."""
    name = _arg(func, args, kwargs, "group_name")
    if name is not None:
        return c10d._resolve_process_group(name).size()
    pg = _arg(func, args, kwargs, "process_group")
    if pg is None:
        raise ValueError(f"{func}: no process group among its arguments")
    return c10d.ProcessGroup.unbox(pg).size()


# a c10d op's result tensors, by its schema's argument names
_RESULT_ARGS = ("output_tensors", "output_tensor", "output", "tensors")


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)``; then ``c.flops``, ``c.bytes``,
    ``c.collectives``, ``c.peak_bytes``, ``c.top_bytes(n)``, ``c.kernels``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.instr_count = 0
        self.collectives: Dict[str, float] = defaultdict(float)
        self.kernels: Dict[str, int] = defaultdict(int)   # kernel name -> records
        self.live_bytes = 0
        self.peak_bytes = 0
        self._rows: Dict[Tuple[str, str], List[float]] = {}
        self._tracked: Dict[int, int] = {}                # storage id -> bytes
        self._depth = 0                                   # open kernel regions

    def __enter__(self):
        global _open
        _open += 1
        try:
            return super().__enter__()
        except BaseException:
            _open -= 1
            raise

    def __exit__(self, *exc):
        global _open
        try:
            return super().__exit__(*exc)
        finally:
            _open -= 1

    # ------------------------------------------------------------------ summary
    def collective_bytes(self) -> Dict[str, float]:
        """The reference's ``collective_bytes`` dict: per-kind wire bytes,
        ``count_<kind>`` and ``total``."""
        out = dict(self.collectives)
        out["total"] = sum(v for k, v in out.items() if k in COLLECTIVES)
        return out

    def top_bytes(self, n: int = 20):
        """The heaviest ops by bytes, summed over their calls at one result
        shape: ``(bytes, op, shape, calls)`` rows, heaviest first."""
        rows = [(b, op, shape, int(calls)) for (op, shape), (b, calls) in self._rows.items()]
        rows.sort(reverse=True)
        return rows[:n]

    # ---------------------------------------------------------- kernel region
    @contextmanager
    def kernel(self, name: str, *, flops: float, bytes: float):
        """Records one launch of the hand-written kernel ``name`` and counts
        nothing that runs beneath the region."""
        if self._depth == 0:
            self.flops += flops
            self.bytes += bytes
            self.instr_count += 1
            self.kernels[name] += 1
            self._row(name, "kernel", bytes)
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    # ------------------------------------------------------------- the mode
    def _row(self, op: str, shape: str, b: float) -> None:
        row = self._rows.setdefault((op, shape), [0.0, 0])
        row[0] += b
        row[1] += 1

    def _free(self, key: int) -> None:
        self.live_bytes -= self._tracked.pop(key, 0)

    def _track(self, outs, ins) -> None:
        seen = {id(s) for s in map(_storage, ins) if s is not None}
        for t in outs:
            s = _storage(t)
            if s is None or id(s) in seen or id(s) in self._tracked:
                continue
            seen.add(id(s))
            nb = s.nbytes()
            self._tracked[id(s)] = nb
            weakref.finalize(s, self._free, id(s))
            self.live_bytes += nb
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._track(outs, ins)
        if self._depth or _no_bytes(func):
            return out
        name = func.__name__.split(".")[0]
        ns = func.namespace
        kind = (_FUNCTIONAL.get(name) if ns == "_c10d_functional"
                else _C10D.get(name) if ns == "c10d" else None)
        written = outs or _written(func, args, kwargs)
        b = float(sum(map(nbytes, ins)) + sum(map(nbytes, written)))
        self.bytes += b
        self.instr_count += 1
        shape = str(tuple(_local(outs[0]).shape)) if outs else "()"
        self._row(f"{ns}.{name}", shape, b)
        packet = func._overloadpacket
        if packet in _FLOP_OPS:
            self.flops += float(_FLOP_OPS[packet](*args, **kwargs, out_val=out))
        if kind is not None:
            self._collective(kind, func, args, kwargs, outs)
        return out

    def _collective(self, kind, func, args, kwargs, outs) -> None:
        g = _group_size(func, args, kwargs)
        res = outs
        if func.namespace == "c10d":
            res = next(_tensors(r) for r in (_arg(func, args, kwargs, n) for n in _RESULT_ARGS)
                       if r is not None)
        b = float(sum(map(nbytes, res)))
        if kind == "all-reduce":
            wire = 2.0 * b * (g - 1) / max(g, 1)
        elif kind == "all-gather":
            wire = b * (g - 1) / max(g, 1)
        elif kind == "reduce-scatter":
            wire = b * (g - 1)            # result is 1/g of operand
        elif kind == "all-to-all":
            wire = b * (g - 1) / max(g, 1)
        else:                              # collective-permute
            wire = b
        self.collectives[kind] += wire
        self.collectives["count_" + kind] += 1


def active() -> Optional[CostCounter]:
    """The innermost active ``CostCounter``, or ``None``."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


_NOTHING = nullcontext()


def kernel(name: str, counts, *args):
    """The active counter's region of the kernel ``name``, whose
    ``counts(*args)`` gives its (FLOPs, bytes). With no counter open it reads
    one global and returns a no-op region: the mode stack is walked and
    ``counts`` called only while a counter is open."""
    if not _open:
        return _NOTHING
    c = active()
    if c is None:
        return _NOTHING
    flops, nbytes = counts(*args)
    return c.kernel(name, flops=flops, bytes=nbytes)
