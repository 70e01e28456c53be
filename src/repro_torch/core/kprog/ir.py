"""Kernel-program IR: declarative warp-specialization layer.

Warp-specialized pipelines are naturally described as role-annotated async
dataflow (Tawa, arXiv:2510.14719) rather than unrolled instruction lists.
A :class:`KernelSpec` declares

  * warpgroup **roles** (``producer``, ``consumer`` x2, ...) — the CTA's
    logical threads, named so downstream analysis can aggregate by role
    instead of hardcoded WG indices;
  * **ring buffers** (named, staged) — the K/V smem pipelines; the builder
    owns the mapping from (ring, slot) to mbarrier/stage sids;
  * per-iteration **async ops with named tokens** — loads signal tokens,
    consumers wait on them, named barriers pass scheduling tokens between
    roles (ping-pong).

``KernelSpec.build()`` lowers a spec to the existing ``isa.Instr`` lists /
:class:`~repro_torch.core.engine.CTATrace` the cycle engine consumes — the IR is
a front end, the engine and its waiter-indexed scheduler are unchanged.
Lowering is deterministic and bit-stable: the registered FA3 ping-pong spec
reproduces the pre-IR hardcoded generator instruction-for-instruction
(``tests/test_kprog.py``), so golden cycle anchors do not move.

Number assignment rules (all bookkeeping the old generators did by hand):

  * ring sids — slot-major interleave across the declared rings when all
    rings share a stage count (K/V ping-pong layout: K->0,2  V->1,3),
    contiguous per-ring blocks otherwise;
  * token sids — allocated upward from ``isa.Q_READY_SID`` in first-use
    order;
  * named-barrier bids — first-use order from 0;
  * WGMMA commit groups — a per-warpgroup counter, one gid per ``gemm()``;
  * epilogue TMA store groups — ``isa.EPILOGUE_GID``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import isa
from repro_torch.core.engine import CTATrace
from repro_torch.core.isa import Instr, TensorMap
from repro_torch.core.machine import GPUMachine


@dataclass(frozen=True)
class Role:
    """One warpgroup role; ``count`` instances share the role body."""
    name: str
    count: int = 1

    def labels(self) -> List[str]:
        if self.count == 1:
            return [self.name]
        return [f"{self.name}{i}" for i in range(self.count)]


@dataclass(frozen=True)
class Ring:
    """A named smem ring buffer streamed through ACQUIRE/RELEASE stages."""
    name: str
    stages: int


class WGProgram:
    """Instruction emitter for one warpgroup, written in role/token
    vocabulary; owns the per-WG WGMMA commit-group counter."""

    def __init__(self, builder: "CTABuilder", label: str):
        self.builder = builder
        self.label = label
        self.instrs: List[Instr] = []
        self._gid = 0
        # instr index -> (ring, raw slot) for every acquire; rides along on
        # CTATrace.acq_slots so the verifier can reconstruct pre-wrap slot
        # numbers (sid folds slot % stages — see CTABuilder.sid)
        self.acq_slots: Dict[int, Tuple[str, int]] = {}

    # -- producer side -------------------------------------------------
    def acquire(self, ring: str, slot: int) -> None:
        """pipeline.producer_acquire on the ring slot (blocks while full)."""
        self.acq_slots[len(self.instrs)] = (ring, slot)
        self.instrs.append(Instr(isa.ACQUIRE_STAGE,
                                 sid=self.builder.sid(ring, slot)))

    def load(self, map_id: int, origin: Tuple[int, ...], *,
             ring: Optional[str] = None, slot: int = 0,
             token: Optional[str] = None, tag: str = "",
             bulk: bool = False) -> None:
        """Async TMA tile load signalling either a ring slot or a named
        point-to-point token."""
        if (ring is None) == (token is None):
            raise ValueError("load() needs exactly one of ring= or token=")
        sid = (self.builder.token(token) if token is not None
               else self.builder.sid(ring, slot))
        self.instrs.append(Instr(isa.TMA_TENSOR, map_id=map_id, sid=sid,
                                 origin=origin, tag=tag, bulk=bulk))

    # -- consumer side -------------------------------------------------
    def wait_tile(self, ring: str, slot: int) -> None:
        self.instrs.append(Instr(isa.MB_WAIT,
                                 sid=self.builder.sid(ring, slot)))

    def wait_token(self, token: str) -> None:
        self.instrs.append(Instr(isa.MB_WAIT, sid=self.builder.token(token)))

    def release(self, ring: str, slot: int) -> None:
        self.instrs.append(Instr(isa.RELEASE_STAGE,
                                 sid=self.builder.sid(ring, slot)))

    # -- named-barrier scheduling tokens -------------------------------
    def arrive(self, bar: str) -> None:
        self.instrs.append(Instr(isa.BAR_ARRIVE, bid=self.builder.bar(bar)))

    def await_arrivals(self, bar: str, n: int) -> None:
        """Block until the named barrier has >= ``n`` total arrivals."""
        self.instrs.append(Instr(isa.BAR_WAIT, bid=self.builder.bar(bar),
                                 n=n))

    # -- compute -------------------------------------------------------
    def gemm(self, *, m: int, n: int, steps: int, tag: str = "",
             wait: int = 0) -> int:
        """One logical GEMM: ``steps`` k16 WGMMAs sharing a fresh commit
        group, committed, then drained down to ``wait`` outstanding groups
        (``wait=1`` leaves this group in flight — FA3's WAIT_WG_1)."""
        gid = self._gid
        self._gid += 1
        for _ in range(steps):
            self.instrs.append(Instr(isa.WGMMA, gid=gid, m=m, n=n, k=16,
                                     tag=tag))
        self.instrs.append(Instr(isa.WGMMA_COMMIT, gid=gid))
        self.instrs.append(Instr(isa.WGMMA_WAIT, gid=gid, n=wait))
        return gid

    def bubbles(self, cycles: int) -> None:
        if cycles > 0:
            self.instrs.append(Instr(isa.BUBBLES, cycles=cycles))

    # -- epilogue ------------------------------------------------------
    def store(self, map_id: int, origin: Tuple[int, ...], *, tag: str = "",
              gid: int = isa.EPILOGUE_GID) -> None:
        """Async TMA store + commit + full drain (epilogue group)."""
        self.instrs.append(Instr(isa.TMA_STORE, map_id=map_id, gid=gid,
                                 origin=origin, tag=tag))
        self.instrs.append(Instr(isa.TMA_COMMIT, gid=gid))
        self.instrs.append(Instr(isa.TMA_WAIT, gid=gid, n=0))


class CTABuilder:
    """Allocates sids/bids/tokens for one CTA and collects its role
    programs into a :class:`CTATrace`."""

    def __init__(self, rings: Iterable[Ring] = (), n_consumers: int = 1,
                 name: str = ""):
        self.rings = list(rings)
        self.n_consumers = n_consumers
        self.name = name
        self._ring_index = {r.name: i for i, r in enumerate(self.rings)}
        stage_counts = {r.stages for r in self.rings}
        self._interleaved = len(stage_counts) <= 1
        if not self._interleaved:
            base, self._ring_base = 0, {}
            for r in self.rings:
                self._ring_base[r.name] = base
                base += r.stages
        self._tokens: Dict[str, int] = {}
        self._bars: Dict[str, int] = {}
        self._wgs: List[Tuple[str, WGProgram]] = []

    # -- number assignment ---------------------------------------------
    def sid(self, ring: str, slot: int) -> int:
        """Map a (ring, slot) to its mbarrier/stage sid.

        **Wrap contract**: ``slot`` is an *iteration* index, not a physical
        stage — it wraps modulo the ring's declared ``stages`` (slot ``j``
        and ``j + stages`` share a sid on purpose; the ACQUIRE/RELEASE
        counting protocol serializes the reuse).  The wrap is silent by
        design: callers write natural loop indices and the builder owns the
        fold.  What the wrap must *never* do is alias two slots that are
        live at the same time — that is a spec bug (e.g. a prefetch depth
        exceeding ``stages``), and the static verifier
        (``repro_torch.core.kprog.verify``) flags it as ``ring-oversubscription``
        with the pre-wrap slot numbers as witness (recorded per acquire in
        ``CTATrace.acq_slots``)."""
        r = self.rings[self._ring_index[ring]]
        if self._interleaved:
            return (slot % r.stages) * len(self.rings) + self._ring_index[ring]
        return self._ring_base[ring] + slot % r.stages

    def token(self, name: str) -> int:
        if name not in self._tokens:
            self._tokens[name] = isa.Q_READY_SID + len(self._tokens)
        return self._tokens[name]

    def bar(self, name: str) -> int:
        if name not in self._bars:
            self._bars[name] = len(self._bars)
        return self._bars[name]

    # -- role programs ---------------------------------------------------
    def wg(self, label: str) -> WGProgram:
        prog = WGProgram(self, label)
        self._wgs.append((label, prog))
        return prog

    def finish(self) -> CTATrace:
        # ring -> stage-sid metadata rides along so observability can map
        # mbarrier/release state back to declared ring buffers; the engine
        # itself never reads it.  Token sids and per-acquire raw slots ride
        # along for the static verifier (sid-space collisions, aliasing
        # witnesses).
        rings = {r.name: tuple(self.sid(r.name, s) for s in range(r.stages))
                 for r in self.rings}
        return CTATrace(wgs=[p.instrs for _, p in self._wgs],
                        n_consumers=self.n_consumers, name=self.name,
                        roles=[lbl for lbl, _ in self._wgs],
                        rings=rings or None,
                        tokens=dict(self._tokens) or None,
                        acq_slots=[dict(p.acq_slots) for _, p in self._wgs])


class KernelSpec:
    """Base class for registered kernel programs.

    Subclasses declare ``name``/``roles``/``scheduling`` and implement the
    geometry (``grid``/``tmaps``/``total_ctas``) plus ``cta()`` — the role
    programs, written against :class:`CTABuilder`.  The analytical traffic
    hooks let SimFA-python (Eq. 2/3/6) specialize per scenario; the defaults
    raise so a new kernel cannot silently inherit FA3 arithmetic.
    """

    name: str = "?"
    roles: Tuple[Role, ...] = ()
    scheduling: str = "?"          # "ping-pong" | "cooperative" | ...

    # -- geometry --------------------------------------------------------
    def default_tiling(self):
        raise NotImplementedError

    def probe_workload(self):
        """A minimal representative workload for resolve-time verification
        (``registry.get`` statically verifies each spec's lowered probe
        launch once).  The default prefill shape exercises ring wrap
        (several KV tiles per ring stage) and grouped heads; decode-shaped
        kernels override (``w.L`` must be 1 there)."""
        from repro_torch.configs.llama3 import AttnWorkload
        return AttnWorkload(name=f"{self.name}-probe", B=1, L=128, S=704,
                            H_kv=1, G=2, D=64)

    def grid(self, w, tiling) -> Iterable[dict]:
        """CTA coordinates in launch (rasterization) order."""
        raise NotImplementedError

    def tmaps(self, w, tiling) -> Dict[int, TensorMap]:
        raise NotImplementedError

    def total_ctas(self, w, tiling=None) -> int:
        """Analytic CTA count of the full launch (no trace materialized)."""
        raise NotImplementedError

    def cta(self, cfg: GPUMachine, w, tiling, **coords) -> CTATrace:
        raise NotImplementedError

    # -- lowering --------------------------------------------------------
    def build(self, cfg: GPUMachine, w, tiling=None,
              max_ctas: Optional[int] = None
              ) -> Tuple[List[CTATrace], Dict[int, TensorMap]]:
        """Lower the first ``max_ctas`` CTAs (all when None) to engine
        traces.  ``max_ctas=0`` means zero CTAs, not unlimited."""
        tiling = tiling if tiling is not None else self.default_tiling()
        tmaps = self.tmaps(w, tiling)
        ctas: List[CTATrace] = []
        for coords in self.grid(w, tiling):
            if max_ctas is not None and len(ctas) >= max_ctas:
                break
            ctas.append(self.cta(cfg, w, tiling, **coords))
        return ctas, tmaps

    # -- analytical traffic hooks (SimFA-python Eq. 2/3/6 per kernel) ----
    def flops(self, w) -> float:
        from repro_torch.core import analytical
        return analytical.total_flops(w)

    def ramp_bubble_cycles(self, cfg: GPUMachine, w, t_m: int,
                           t_n: int) -> int:
        """One steady-state softmax-bubble block for the analytical ramp
        (fill/drain) term.  The default charges the standard (t_m x t_n)
        consumer tile; kernels with differently shaped compute blocks
        (e.g. decode's G-row tiles) override."""
        from repro_torch.core.kprog.costs import softmax_bubble_cycles
        return softmax_bubble_cycles(cfg, t_m, t_n, w.D)

    def l2_traffic(self, w, t_m: int = 64, tiling=None) -> float:
        raise NotImplementedError(f"{self.name}: no L2 traffic hook")

    def dram_ideal(self, w) -> float:
        raise NotImplementedError(f"{self.name}: no ideal-DRAM hook")

    def dram_real(self, w, t_m: int, n_sm: int, o_limit: int,
                  tiling=None) -> float:
        raise NotImplementedError(f"{self.name}: no real-DRAM hook")
