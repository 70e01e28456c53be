"""Sim-FA core: event-driven, WarpGroup-granular cycle-level engine.

Implements the paper's Algorithm 1:
  * each WarpGroup is a *logical thread* with a single instruction flow;
  * the Scheduler dispatches logical threads (grouped in CTAs) to physical
    SM slots under the occupancy limit, and plays warp-scheduler (GTO)
    among resident threads;
  * the Frontend issues in order, executes out of order: async ops are
    handed to the TMA / TensorCore engines, waits with unmet conditions
    roll the PC back and park the thread on a waiter list (AEQ);
  * mbarriers, pipeline stages (producer_acquire / consumer_release),
    WGMMA commit groups, TMA store groups and named barriers are modeled
    in full — the paper found incomplete barrier modeling breaks overlap
    estimation (§4.1).

The default run loop (``scheduler="event"``) is a true discrete-event
loop: time jumps straight to the next interesting cycle — the event-queue
head or the next cycle any SM can issue — and *nothing scans threads*.
Each SM keeps a maintained issue-eligible ready queue (READY, non-busy,
non-done threads in GTO dispatch order), ``busy_until`` sleepers park on
coalesced per-SM timer events (``EventQueue.wake_at``), and the active-SM
set is a flag-guarded min-heap drained in ascending id order.  That is
what makes a Python implementation viable where the paper uses C++.

Scheduling is *condition-indexed*: a thread whose wait condition fails is
parked on a waiter list keyed by exactly what it waits for — an mbarrier
``(cta, sid)`` signal, a stage-release count, its own WGMMA/TMA group
drain, a named-barrier arrival, a tensor-core buffer slot, or a
``busy_until`` timer — and each completion event wakes only the threads
whose condition just became satisfiable.  A woken thread's condition is
always re-validated at issue time in ``SM.step``, so a spurious wake is
harmless; the wake index only has to never *miss* a wake.  Two fallback
schedulers survive for equivalence testing and deadlock safety:
``scheduler="waiter"`` (the condition-indexed scan loop this PR's event
loop grew out of) and ``scheduler="broadcast"`` / ``broadcast_wake=True``
(every completion re-marks every resident thread READY and rescans).  All
three are cycle-for-cycle *bit-exact* — identical ``stats()`` dicts and
event streams (see ``tests/test_engine_equiv.py``).
"""
from __future__ import annotations

from bisect import insort
from collections import deque
from dataclasses import dataclass
from operator import attrgetter
from typing import Dict, List, Optional, Tuple

from repro_torch.core import isa
from repro_torch.core.isa import Instr, TensorMap
from repro_torch.core.machine import GPUMachine
from repro_torch.core.memory import EventQueue, build_memory
from repro_torch.obs.labels import make_label

READY, STALLED, DONE = 0, 1, 2

_ORDER = attrgetter("order")    # GTO dispatch-order sort key

# ops whose issue condition can fail (everything else issues unconditionally;
# WGMMA — the hottest op — is special-cased ahead of the set probe)
_BLOCKING = frozenset((isa.MB_WAIT, isa.ACQUIRE_STAGE, isa.WGMMA_WAIT,
                       isa.TMA_WAIT, isa.BAR_WAIT))


@dataclass
class CTATrace:
    """One thread block: a list of WarpGroup instruction traces.

    ``roles`` optionally names each warpgroup's declared role instance
    (e.g. ``["producer", "consumer0", "consumer1"]``, from the kernel IR);
    thread labels — and therefore stall-attribution keys — use these names
    instead of positional ``wg{i}`` indices when present.

    ``rings`` optionally maps each declared ring buffer to its stage sids
    (``{"K": (0, 2), "V": (1, 3)}``, from the kernel IR) — pure metadata
    the engine never reads; the counter sink uses it to derive per-ring
    occupancy depth from the mbarrier/release state.

    ``tokens`` (name -> sid) and ``acq_slots`` (per-WG ``{instr index:
    (ring, raw slot)}`` for ACQUIRE_STAGE instructions) are further
    IR-metadata riders consumed by the static verifier
    (``repro_torch.core.kprog.verify``) — sid-space collision checks need the
    token allocation, and slot-aliasing witnesses need the pre-wrap slot
    numbers that lowering folds into sids."""
    wgs: List[List[Instr]]
    n_consumers: int = 2
    name: str = ""
    roles: Optional[List[str]] = None
    rings: Optional[Dict[str, Tuple[int, ...]]] = None
    tokens: Optional[Dict[str, int]] = None
    acq_slots: Optional[List[Dict[int, Tuple[str, int]]]] = None


class WGThread:
    __slots__ = ("trace", "trace_len", "pc", "state", "cta", "wg_id", "sm",
                 "busy_until", "wgmma_groups", "tma_groups", "wgmma_out",
                 "tma_out", "mb_expected", "acq_count", "label", "parked",
                 "order", "in_ready", "mma_pending")

    def __init__(self, trace, cta, wg_id):
        self.trace = trace
        self.trace_len = len(trace)
        self.pc = 0
        self.state = READY
        self.cta = cta
        self.wg_id = wg_id
        self.sm = None
        self.busy_until = 0
        # per-WG async group bookkeeping: gid -> [issued, completed, committed]
        self.wgmma_groups: Dict[int, List] = {}
        self.tma_groups: Dict[int, List] = {}
        # committed-but-incomplete group ids; len() is the outstanding count
        # the drain waits test, so WGMMA_WAIT/TMA_WAIT checks are O(1)
        self.wgmma_out: set = set()
        self.tma_out: set = set()
        # lazy-completion FIFO (event scheduler): (cycle, gid) per in-pipe
        # WGMMA, applied to wgmma_groups on observation instead of per-event
        self.mma_pending: deque = deque()
        self.mb_expected: Dict[int, int] = {}
        self.acq_count: Dict[int, int] = {}
        self.label = ""
        self.parked = False      # registered on a keyed waiter list
        self.order = (0, wg_id)  # GTO dispatch-order key, set by CTA
        self.in_ready = False    # member of its SM's issue-eligible queue

    def done(self):
        return self.pc >= self.trace_len


class CTA:
    __slots__ = ("trace", "threads", "mbarrier", "stage_releases",
                 "bar_arrivals", "n_consumers", "idx", "done_wgs",
                 "mb_waiters", "stage_waiters", "bar_waiters")

    def __init__(self, trace: CTATrace, idx: int):
        self.trace = trace
        self.idx = idx
        self.n_consumers = trace.n_consumers
        self.threads = [WGThread(t, self, i) for i, t in enumerate(trace.wgs)]
        roles = trace.roles
        for i, t in enumerate(self.threads):
            role = roles[i] if roles and i < len(roles) else f"wg{i}"
            t.label = make_label(idx, role)
            t.order = (idx, i)
        self.mbarrier: Dict[int, int] = {}        # sid -> completed signals
        self.stage_releases: Dict[int, int] = {}  # sid -> consumer releases
        self.bar_arrivals: Dict[int, int] = {}    # bid -> arrivals
        self.done_wgs = 0
        # condition-indexed waiter lists (waiter-mode scheduler only)
        self.mb_waiters: Dict[int, List[WGThread]] = {}
        self.stage_waiters: Dict[int, List[WGThread]] = {}
        self.bar_waiters: Dict[int, List[WGThread]] = {}


class TensorCoreEngine:
    """Single tensor-core pipeline + WGMMA issue buffer per SM (§4.2)."""

    def __init__(self, cfg: GPUMachine, evq: EventQueue, sm):
        self.cfg = cfg
        self.evq = evq
        self.sm = sm
        self.buffer: deque = deque()   # (WGThread, Instr, nid)
        # Defensive waiter list: _pump pops synchronously on every push
        # (serialization is modeled via busy_until), so with the current
        # pipeline model can_accept() never fails and nothing parks here.
        # The list exists so a future occupancy-accurate buffer model can't
        # introduce a missed-wake deadlock on the WGMMA stall path.
        self.waiters: List[WGThread] = []   # threads parked on a buffer slot
        self.busy_until = 0
        self.busy_cycles = 0
        self.faults = sm.engine.faults
        self._div = cfg.wgmma_n_cycles_divisor
        self._dur_memo: Dict[int, int] = {}   # ins.n -> pipeline cycles
        # Lazy completion mode (event scheduler, no sanitizer): a WGMMA's
        # completion only mutates its own thread's group counters and can
        # only wake that thread from its own WGMMA_WAIT, so instead of one
        # EventQueue callback per WGMMA the completion is queued on
        # th.mma_pending and folded in at the few sites that observe group
        # state; a stalled drain wait gets ONE wake event at its exactly
        # computable satisfaction cycle (the pipe is serial, so pending
        # completion cycles are known at stall time).
        self.lazy = (sm.engine.scheduler == "event"
                     and sm.engine.sanitizer is None)

    def can_accept(self) -> bool:
        return len(self.buffer) < self.cfg.wgmma_issue_buffer

    def _apply(self, th: WGThread, now: int):
        """Fold every lazily queued completion at or before ``now`` into the
        thread's group counters (the work _complete does eagerly)."""
        pend = th.mma_pending
        if not pend:
            return
        groups = th.wgmma_groups
        out = th.wgmma_out
        while pend and pend[0][0] <= now:
            _, gid = pend.popleft()
            g = groups[gid]
            g[1] += 1
            if g[2] and g[1] >= g[0]:
                out.discard(gid)

    def push(self, cycle: int, th: WGThread, ins: Instr, nid: int = -1):
        pend = th.mma_pending
        if pend and pend[0][0] <= cycle:
            self._apply(th, cycle)     # reuse check below reads g[1]
        groups = th.wgmma_groups
        g = groups.get(ins.gid)
        if g is None:                  # .get avoids setdefault's list alloc
            groups[ins.gid] = g = [0, 0, False]
        g[0] += 1
        if g[2] and g[1] == g[0] - 1:
            # a committed, fully drained group id got reused: outstanding again
            th.wgmma_out.add(ins.gid)
        if self.buffer:
            self.buffer.append((th, ins, nid))
            self._pump(cycle)
            return
        # fast path: the buffer is empty (the synchronous pop in _pump keeps
        # it so), so this op heads straight into the pipe — same arithmetic
        # as _pump without the deque round-trip, with the N->cycles mapping
        # memoized (the divisor is frozen per machine config)
        start = self.busy_until
        if start < cycle:
            start = cycle
        dur = ins.cycles
        if dur <= 0:
            memo = self._dur_memo
            dur = memo.get(ins.n)
            if dur is None:
                dur = max(1, int(round(ins.n / self._div)))
                memo[ins.n] = dur
        fl = self.faults
        if fl is not None:
            dur = fl.stretch(start, self.sm.sm_id, dur)
        self.busy_until = start + dur
        self.busy_cycles += dur
        if self.sm.tracer is not None:
            self.sm.tracer.on_mma(nid, th, ins, start, start + dur)
        if self.lazy:
            th.mma_pending.append((start + dur, ins.gid))
        else:
            self.evq.push(start + dur, self._complete, th, ins.gid)

    def _pump(self, cycle: int):
        if not self.buffer:
            return
        start = max(cycle, self.busy_until)
        th, ins, nid = self.buffer.popleft()
        # GPU mode: FP16 m64nNk16 completes in ~N/2 cycles (paper §4.2);
        # TPU mode: the tracegen precomputes MXU cycles into ins.cycles.
        dur = ins.cycles if ins.cycles > 0 else max(
            1, int(round(ins.n / self.cfg.wgmma_n_cycles_divisor)))
        fl = self.faults
        if fl is not None:
            dur = fl.stretch(start, self.sm.sm_id, dur)
        self.busy_until = start + dur
        self.busy_cycles += dur
        if self.sm.tracer is not None:
            self.sm.tracer.on_mma(nid, th, ins, start, start + dur)
        if self.lazy:
            th.mma_pending.append((start + dur, ins.gid))
        else:
            self.evq.push(start + dur, self._complete, th, ins.gid)

    def drain_wake_cycle(self, th: WGThread, ins: Instr) -> Optional[int]:
        """Cycle at which ``th``'s WGMMA_WAIT drain condition flips true.

        The TC pipe is strictly serial, so the pending completions' cycles
        and group ids are already determined; walk them in order, retiring
        outstanding groups <= ins.gid, until enough have drained.  Returns
        None if pending completions cannot satisfy the wait (then no
        eager completion event would have woken the thread either)."""
        gid = ins.gid
        groups = th.wgmma_groups
        rem: Dict[int, int] = {}
        for g_ in th.wgmma_out:
            if g_ <= gid:
                g = groups[g_]
                rem[g_] = g[0] - g[1]
        need = len(rem) - ins.n
        if need <= 0:
            return None
        for t, g_ in th.mma_pending:
            r = rem.get(g_)
            if r is not None:
                r -= 1
                rem[g_] = r
                if r == 0:
                    need -= 1
                    if need == 0:
                        return t
        return None

    def _drain_wake(self, th: WGThread):
        """Scheduled wake for a lazily tracked WGMMA_WAIT stall."""
        self._apply(th, self.sm.engine.cycle)
        self.sm.notify_group(th)

    def _complete(self, th: WGThread, gid: int):
        g = th.wgmma_groups[gid]
        g[1] += 1
        if g[2] and g[1] >= g[0]:
            th.wgmma_out.discard(gid)
        # inlined notify_group guard: the issuing thread is usually still
        # running (not stalled on its own drain), so skip the call entirely
        sm = self.sm
        if sm.broadcast:
            sm.wake_all()
        elif th.state == STALLED and not th.parked:
            sm.notify_group(th)
        if self.buffer:
            self._pump(self.busy_until)
        if self.waiters:
            sm.notify_tc()


class TMAEngine:
    """Per-SM TMA engine: descriptor setup, HW address generation with line
    dedup, bounded in-flight lines, mbarrier signaling (§4.3).

    The line path is *batched*: each cycle's issuable lines go to the LRC in
    one ``request_many`` call sharing a single per-job completion callback
    (a shared counter), instead of one closure per line; finished jobs are
    retired at completion time, so ``jobs`` only ever holds live jobs."""

    def __init__(self, cfg: GPUMachine, evq: EventQueue, sm, lrc, tmaps):
        self.cfg = cfg
        self.evq = evq
        self.sm = sm
        self.eng = sm.engine
        self.lrc = lrc
        self.tmaps = tmaps
        self.faults = sm.engine.faults
        # tile fidelity: the front end is a TileMemory and whole tiles are
        # charged as single bulk transactions (no per-line issue machinery)
        self._tile_mem = lrc if sm.engine.mem_fidelity == "tile" else None
        # frozen-config hot constants, hoisted off the issue path
        self._lpc = cfg.tma_lines_per_cycle
        self._cap = cfg.tma_max_inflight_lines
        self.jobs: List[dict] = []    # live jobs, round-robin issue order
        self.lines_issued = 0
        self.lines_queued = 0         # un-issued lines across all live jobs
        self._kick_scheduled = False
        self._issue_cycle = -1
        self._issued_in_cycle = 0

    def _tile_lines(self, ins: Instr):
        """Hardware address generation, cached per (map, origin): CTAs of the
        same KV head stream identical K/V tiles (Eq. 5/6 reuse structure).
        Caching starts on the *second* encounter so per-CTA-unique tiles
        (Q loads, O stores) cost a set entry, not a retained line list."""
        eng = self.sm.engine
        key = (ins.map_id, ins.origin)
        lines = eng.tile_cache.get(key)
        if lines is None:
            tm: TensorMap = self.tmaps[ins.map_id]
            lines = tm.tile_lines(ins.origin, self.cfg.line_bytes,
                                  dedup=self.cfg.tma_dedup)
            seen = eng.tile_seen
            if key in seen:
                eng.tile_cache[key] = lines
            else:
                seen.add(key)
        return lines

    def submit_load(self, cycle: int, th: WGThread, ins: Instr,
                    nid: int = -1):
        lines = self._tile_lines(ins)
        # Fig. 2: non-tensor bulk requests bypass the descriptor cache and
        # TensorMap setup path -> only the common launch latency applies.
        setup = self.cfg.tma_launch_latency + (
            0 if ins.bulk else self.cfg.tma_tmap_setup_latency)
        fl = self.faults
        if fl is not None:
            setup += fl.tma_extra()
        if self._tile_mem is not None:
            self._submit_tile(cycle, th, ins, nid, False, setup, lines)
            return
        job = {"lines": deque(lines), "left": len(lines), "th": th,
               "sid": ins.sid, "write": False, "tag": ins.tag, "t0": cycle,
               "inflight": 0, "nid": nid, "setup": setup}
        job["done"] = self._make_done(job)
        self.evq.push(cycle + setup, self._start, job)

    def submit_store(self, cycle: int, th: WGThread, ins: Instr,
                     nid: int = -1):
        lines = self._tile_lines(ins)
        g = th.tma_groups.setdefault(ins.gid, [0, 0, False])
        g[0] += 1
        if g[2] and g[1] == g[0] - 1:
            th.tma_out.add(ins.gid)
        # stores bypass the TensorMap setup path only when bulk (Fig. 2);
        # FA3's O store uses a TensorMap -> full setup
        setup = self.cfg.tma_launch_latency + self.cfg.tma_tmap_setup_latency
        fl = self.faults
        if fl is not None:
            setup += fl.tma_extra()
        if self._tile_mem is not None:
            self._submit_tile(cycle, th, ins, nid, True, setup, lines)
            return
        job = {"lines": deque(lines), "left": len(lines), "th": th,
               "gid": ins.gid, "write": True, "tag": ins.tag, "t0": cycle,
               "inflight": 0, "nid": nid, "setup": setup}
        job["done"] = self._make_done(job)
        self.evq.push(cycle + setup, self._start, job)

    # -- tile fidelity: one bulk transaction + one completion event per job
    def _submit_tile(self, cycle: int, th: WGThread, ins: Instr, nid: int,
                     write: bool, setup: int, lines):
        job = {"lines": (), "left": 0, "th": th, "write": write,
               "tag": ins.tag, "t0": cycle, "inflight": len(lines),
               "nid": nid, "setup": setup}
        if write:
            job["gid"] = ins.gid
        else:
            job["sid"] = ins.sid
        self.lines_issued += len(lines)
        self.evq.push(cycle + setup, self._start_tile, job, lines)

    def _start_tile(self, job, lines):
        self.jobs.append(job)    # live while in flight: counter sink samples
        t = self._tile_mem.transact(self.eng.cycle, lines, self.sm.sm_id,
                                    job["write"])
        fl = self.eng.faults
        if fl is not None:
            d = fl.finish_delay()
            if d:
                t += d
        self.evq.push(t, self._retire_tile, job)

    def _retire_tile(self, job):
        job["inflight"] = 0
        self._finish(job)

    def _make_done(self, job):
        """One shared completion callback per job — the LRC invokes it once
        per finished line (shared counter, no per-line closures).

        The steady-state path is *targeted*: between issue events, only the
        job whose line just completed can have both queued lines and
        in-flight room (any other job with room would already have issued
        when capacity last appeared), so — mid-cycle, budget permitting —
        its replacement line is issued directly instead of re-scanning all
        live jobs.  The full scan is kept for cycle boundaries, where the
        budget resets and rate-limited jobs must issue in legacy order."""
        lrc = self.lrc
        eng = self.eng
        sm_id = self.sm.sm_id
        def done():
            job["left"] -= 1
            if job["left"] == 0:
                fl = eng.faults
                d = fl.finish_delay() if fl is not None else 0
                if d:
                    # delayed async-completion delivery: the last line has
                    # landed but the mbarrier signal / group retirement only
                    # becomes visible d cycles later.  The job stays in
                    # self.jobs (empty line deque -> _issue skips it).
                    self.evq.push(eng.cycle + d, self._finish, job)
                else:
                    self._finish(job)
                if (self.lines_queued and self._kick_scheduled
                        and eng.cycle > self._issue_cycle):
                    self._issue(eng.cycle)
                return
            lines = job["lines"]
            now = eng.cycle
            if now > self._issue_cycle:
                if self._kick_scheduled:
                    # an unfired carry-over kick covers rate-limited jobs
                    # that must issue first, in legacy scan order
                    job["inflight"] -= 1
                    if self.lines_queued:
                        self._issue(now)
                    return
                if not lines:
                    job["inflight"] -= 1
                    return
                # fresh cycle, no carry-over work: the budget resets and
                # this job is the only issue-eligible one
                self._issue_cycle = now
                self._issued_in_cycle = 1
                self.lines_issued += 1
                self.lines_queued -= 1
                lrc.request_one(now, lines.popleft(), sm_id, done,
                                job["write"])
                return
            if lines and self._issued_in_cycle < self._lpc:
                # targeted refill: this job freed exactly one slot, and no
                # other job can be issue-eligible mid-cycle (see above)
                self._issued_in_cycle += 1
                self.lines_issued += 1
                self.lines_queued -= 1
                lrc.request_one(now, lines.popleft(), sm_id, done,
                                job["write"])
                return
            job["inflight"] -= 1
            if lines and not self._kick_scheduled:
                # budget spent with lines still queued: carry over
                self._kick_scheduled = True
                self.evq.push(now + 1, self._kick)
        return done

    def _start(self, job):
        self.jobs.append(job)
        self.lines_queued += len(job["lines"])
        self._issue(self._now())

    def _now(self):
        return self.eng.cycle

    def _issue(self, cycle: int):
        """Issue up to tma_lines_per_cycle lines this cycle, round-robin over
        in-flight TMA ops; max_inflight_lines bounds each op's outstanding
        lines (several ops stream concurrently through the ring buffer)."""
        if cycle > self._issue_cycle:
            self._issue_cycle = cycle
            self._issued_in_cycle = 0
        budget = self._lpc - self._issued_in_cycle
        if budget > 0 and self.lines_queued:
            inflight_cap = self._cap
            request_one = self.lrc.request_one
            sm_id = self.sm.sm_id
            for job in self.jobs:
                if budget <= 0:
                    break
                lines = job["lines"]
                take = budget
                n = len(lines)
                if n < take:
                    take = n
                room = inflight_cap - job["inflight"]
                if room < take:
                    take = room
                if take <= 0:
                    continue
                job["inflight"] += take
                self.lines_issued += take
                self.lines_queued -= take
                self._issued_in_cycle += take
                budget -= take
                done_cb = job["done"]
                write = job["write"]
                for _ in range(take):
                    request_one(cycle, lines.popleft(), sm_id, done_cb,
                                write)
        # rate-limited this cycle with lines still issuable: kick next cycle.
        # (inflight-capped jobs are re-kicked by their done() callbacks)
        if (self.lines_queued and not self._kick_scheduled
                and self._issued_in_cycle >= self._lpc):
            cap = self._cap
            for j in self.jobs:
                if j["lines"] and j["inflight"] < cap:
                    self._kick_scheduled = True
                    self.evq.push(cycle + 1, self._kick)
                    break

    def _kick(self):
        self._kick_scheduled = False
        self._issue(self._now())

    def _finish(self, job):
        th: WGThread = job["th"]
        signal_n = 0
        if job["write"]:
            g = th.tma_groups[job["gid"]]
            g[1] += 1
            if g[2] and g[1] >= g[0]:
                th.tma_out.discard(job["gid"])
        else:
            cta = th.cta
            cta.mbarrier[job["sid"]] = cta.mbarrier.get(job["sid"], 0) + 1
            signal_n = cta.mbarrier[job["sid"]]
        if self.sm.tracer is not None:
            self.sm.tracer.on_tma(
                job["nid"], th, write=job["write"], tag=job["tag"],
                t0=job["t0"], t1=self._now(), fixed=job["setup"],
                sid=job.get("sid", -1), gid=job.get("gid", -1),
                signal_n=signal_n)
        self.jobs.remove(job)
        if job["write"]:
            self.sm.notify_group(th)
        else:
            self.sm.notify_mb(th.cta, job["sid"])


class SM:
    def __init__(self, sm_id: int, cfg: GPUMachine, engine):
        self.sm_id = sm_id
        self.cfg = cfg
        self.engine = engine
        self.evq = engine.evq
        self.tracer = engine.tracer
        self.broadcast = engine.broadcast_wake
        self.event = engine.scheduler == "event"
        self.san = engine.sanitizer
        self.faults = engine.faults
        self.ctas: List[CTA] = []
        self._threads: List[WGThread] = []   # flat resident non-DONE threads
        # event-mode issue-eligible queue: READY, non-busy, non-done threads
        # in GTO dispatch order (sorted by WGThread.order); kept exact by the
        # state transitions in step()/_execute()/wakes, so neither step() nor
        # the run loop ever scans blocked threads
        self._ready: List[WGThread] = []
        # event-mode busy-timer park: wake cycle -> threads sleeping on
        # busy_until (BUBBLES), woken by one coalesced evq.wake_at per cycle
        self._timers: Dict[int, List[WGThread]] = {}
        self.tc = TensorCoreEngine(cfg, self.evq, self)
        self.tma = TMAEngine(cfg, self.evq, self, engine.lrc, engine.tmaps)
        self.current: Optional[WGThread] = None   # GTO greedy pointer
        self.issue_cycles = 0
        # hot-loop constants (step() runs once per issuing SM per cycle)
        self._iw = cfg.issue_width
        self._tc_cap = cfg.wgmma_issue_buffer

    # ------------------------------------------------------------------
    def threads(self):
        return self._threads

    def _rebuild_threads(self):
        self._threads = [th for cta in self.ctas for th in cta.threads
                         if th.state != DONE]

    def wake_all(self):
        self.engine.mark_active(self)

    def _timer_fire(self, cycle: int):
        """Coalesced busy_until timer (event mode): return every thread whose
        bubble drains at ``cycle`` to the ready queue.  Threads that went
        DONE while draining (trace ended on the bubble) are skipped — their
        retirement is a separate _finish_thread event."""
        for th in self._timers.pop(cycle, ()):
            if th.state == READY:
                th.in_ready = True
                insort(self._ready, th, key=_ORDER)
        if self._ready:
            self.engine.mark_active(self)

    def has_slot(self) -> bool:
        return len(self.ctas) < self.cfg.occupancy_limit

    # ------------------------------------------------------------------
    # condition checks for blocking instructions
    def _cond_met(self, th: WGThread, ins: Instr) -> bool:
        op = ins.op
        if op == isa.WGMMA:             # hottest op: checked first
            return self.tc.can_accept()
        if op not in _BLOCKING:         # non-blocking ops: one set probe
            return True
        cta = th.cta
        if op == isa.MB_WAIT:
            need = th.mb_expected.get(ins.sid, 0) + 1
            return cta.mbarrier.get(ins.sid, 0) >= need
        if op == isa.ACQUIRE_STAGE:
            use = th.acq_count.get(ins.sid, 0)
            if use == 0:
                return True
            return cta.stage_releases.get(ins.sid, 0) >= use * cta.n_consumers
        if op == isa.WGMMA_WAIT:
            pend = th.mma_pending
            if pend and pend[0][0] <= self.engine.cycle:
                self.tc._apply(th, self.engine.cycle)
            out = th.wgmma_out
            if len(out) <= ins.n:       # O(1) fast path: total outstanding
                return True
            gid = ins.gid
            return sum(1 for g in out if g <= gid) <= ins.n
        if op == isa.TMA_WAIT:
            out = th.tma_out
            if len(out) <= ins.n:
                return True
            gid = ins.gid
            return sum(1 for g in out if g <= gid) <= ins.n
        # BAR_WAIT (the only remaining member of _BLOCKING)
        return cta.bar_arrivals.get(ins.bid, 0) >= ins.n

    # ------------------------------------------------------------------
    # waiter index: park / targeted wake (waiter-mode scheduler)
    def _park(self, th: WGThread, ins: Instr):
        """Register a freshly stalled thread under its wake condition.
        WGMMA_WAIT/TMA_WAIT drain only on this thread's own group
        completions, so those are probed directly (no list needed)."""
        if th.parked:
            return
        op = ins.op
        if op == isa.MB_WAIT:
            th.cta.mb_waiters.setdefault(ins.sid, []).append(th)
        elif op == isa.ACQUIRE_STAGE:
            th.cta.stage_waiters.setdefault(ins.sid, []).append(th)
        elif op == isa.BAR_WAIT:
            th.cta.bar_waiters.setdefault(ins.bid, []).append(th)
        elif op == isa.WGMMA:
            self.tc.waiters.append(th)
        else:                       # WGMMA_WAIT / TMA_WAIT: probed via
            # notify_group, not list-parked.  Under lazy completions a
            # WGMMA_WAIT gets its one wake event at the computed drain cycle
            # (TMA_WAIT drains stay eventful via TMAEngine._finish).
            if op == isa.WGMMA_WAIT and self.tc.lazy:
                t = self.tc.drain_wake_cycle(th, ins)
                if t is not None:
                    self.evq.push(t, self.tc._drain_wake, th)
            return
        th.parked = True

    def _drain_waiters(self, lst: List[WGThread]):
        """Wake every parked thread whose condition now holds."""
        woke = False
        kept = []
        event = self.event
        for th in lst:
            if self._cond_met(th, th.trace[th.pc]):
                th.parked = False
                th.state = READY
                if event:
                    th.in_ready = True
                    insort(self._ready, th, key=_ORDER)
                woke = True
            else:
                kept.append(th)
        lst[:] = kept
        if woke:
            self.engine.mark_active(self)

    def _notify_keyed(self, waiters: Dict[int, List[WGThread]], key: int):
        if self.broadcast:
            self.wake_all()
            return
        lst = waiters.get(key)
        if lst:
            self._drain_waiters(lst)

    def notify_mb(self, cta: CTA, sid: int):
        self._notify_keyed(cta.mb_waiters, sid)

    def notify_stage(self, cta: CTA, sid: int):
        self._notify_keyed(cta.stage_waiters, sid)

    def notify_bar(self, cta: CTA, bid: int):
        self._notify_keyed(cta.bar_waiters, bid)

    def notify_group(self, th: WGThread):
        """One of ``th``'s WGMMA/TMA groups completed work: re-check a
        pending drain wait.  ``parked`` threads wait on something else.
        The drain condition is inlined (it fires once per async completion
        with the waiter usually stalled on exactly this drain)."""
        if self.broadcast:
            self.wake_all()
            return
        if th.state == STALLED and not th.parked:
            ins = th.trace[th.pc]
            op = ins.op
            if op == isa.WGMMA_WAIT:
                pend = th.mma_pending
                if pend and pend[0][0] <= self.engine.cycle:
                    self.tc._apply(th, self.engine.cycle)
                out = th.wgmma_out
            elif op == isa.TMA_WAIT:
                out = th.tma_out
            else:
                return
            if len(out) > ins.n:
                gid = ins.gid
                c = 0
                for g in out:
                    if g <= gid:
                        c += 1
                if c > ins.n:
                    return
            th.state = READY
            if self.event:
                th.in_ready = True
                insort(self._ready, th, key=_ORDER)
            self.engine.mark_active(self)

    def notify_tc(self):
        if not self.broadcast and self.tc.waiters:
            self._drain_waiters(self.tc.waiters)

    # ------------------------------------------------------------------
    def step(self, cycle: int) -> bool:
        """Issue up to issue_width instructions. Returns True if progressed."""
        progressed = False
        broadcast = self.broadcast
        event = self.event
        # hot-loop locals: step runs once per issuing SM per cycle, so every
        # attribute fetch hoisted here is ~50k fewer lookups per launch
        tc = self.tc
        tc_buf = tc.buffer
        tc_cap = self._tc_cap
        tracer = self.tracer
        fast_wgmma = self.san is None
        tc_lazy = tc.lazy
        ready = self._ready
        wgmma = isa.WGMMA
        blocking = _BLOCKING
        for _ in range(self._iw):
            issued = False
            if event:
                # inline of _candidates_event: greedy current thread first,
                # then the maintained ready queue in dispatch order.  Eager
                # snapshot is safe — a candidate's stall processing only
                # removes *itself* from the queue, and an issue breaks out
                # of the scan immediately.  With one ready thread the queue
                # itself is the snapshot (a stall empties it, ending the
                # scan; an issue breaks out before any further iteration).
                cur = self.current
                if len(ready) == 1:
                    cands = ready
                elif cur is not None and cur.in_ready:
                    cands = [cur]
                    for t in ready:
                        if t is not cur:
                            cands.append(t)
                else:
                    cands = list(ready)
            else:
                cands = self._candidates(cycle)
            for th in cands:
                ins = th.trace[th.pc]
                # inline of _cond_met's two hottest outcomes (WGMMA issue
                # and non-blocking ops); the blocking waits take the call
                op = ins.op
                if op == wgmma:
                    if len(tc_buf) < tc_cap:
                        # direct dispatch of the hottest op (skips
                        # _execute's chain; WGMMA has no blocking-side
                        # bookkeeping).  Sanitizer runs keep _execute.
                        nid = (tracer.on_issue(cycle, th, ins)
                               if tracer is not None else -1)
                        if tc_lazy and not tc_buf:
                            # inline of TensorCoreEngine.push's fast path
                            # (same arithmetic, minus the two call frames)
                            pend = th.mma_pending
                            if pend and pend[0][0] <= cycle:
                                tc._apply(th, cycle)
                            gid = ins.gid
                            groups = th.wgmma_groups
                            g = groups.get(gid)
                            if g is None:
                                groups[gid] = g = [0, 0, False]
                            g[0] += 1
                            if g[2] and g[1] == g[0] - 1:
                                th.wgmma_out.add(gid)
                            start = tc.busy_until
                            if start < cycle:
                                start = cycle
                            dur = ins.cycles
                            if dur <= 0:
                                memo = tc._dur_memo
                                dur = memo.get(ins.n)
                                if dur is None:
                                    dur = max(1, int(round(ins.n / tc._div)))
                                    memo[ins.n] = dur
                            fl = tc.faults
                            if fl is not None:
                                dur = fl.stretch(start, self.sm_id, dur)
                            end = start + dur
                            tc.busy_until = end
                            tc.busy_cycles += dur
                            if tracer is not None:
                                tracer.on_mma(nid, th, ins, start, end)
                            th.mma_pending.append((end, gid))
                        elif fast_wgmma:
                            tc.push(cycle, th, ins, nid)
                        else:
                            self._execute(cycle, th, ins, nid)
                        th.pc += 1
                    else:
                        th.state = STALLED
                        if not broadcast:
                            self._park(th, ins)
                        if event and th.in_ready:
                            th.in_ready = False
                            ready.remove(th)
                        if self.current is th:
                            self.current = None
                        continue
                elif op in blocking and not self._cond_met(th, ins):
                    th.state = STALLED   # PC rollback: do not advance
                    if not broadcast:
                        self._park(th, ins)
                    if event and th.in_ready:
                        th.in_ready = False
                        ready.remove(th)
                    if self.current is th:
                        self.current = None
                    continue             # GTO: fall through to next-oldest
                else:
                    # trace before counters mutate: dep ordinals snapshot
                    nid = (tracer.on_issue(cycle, th, ins)
                           if tracer is not None else -1)
                    if op == isa.MB_WAIT:
                        th.mb_expected[ins.sid] = \
                            th.mb_expected.get(ins.sid, 0) + 1
                    elif op == isa.ACQUIRE_STAGE:
                        th.acq_count[ins.sid] = \
                            th.acq_count.get(ins.sid, 0) + 1
                    self._execute(cycle, th, ins, nid)
                    th.pc += 1
                self.current = th        # greedy: keep issuing this thread
                issued = True
                if th.pc >= th.trace_len:
                    th.state = DONE
                    self.current = None
                    if event and th.in_ready:
                        th.in_ready = False
                        self._ready.remove(th)
                    # retirement waits for trailing in-flight work (bubbles)
                    fin = max(cycle, th.busy_until)
                    if fin > cycle:
                        self.evq.push(fin, self._finish_thread, th)
                    else:
                        self._finish_thread(th)
                break
            if not issued:
                break
            progressed = True
        return progressed

    def _candidates(self, cycle: int):
        """Greedy-then-oldest order: current thread first, then dispatch order."""
        cur = self.current
        if (cur is not None and cur.state == READY
                and cur.pc < cur.trace_len and cur.busy_until <= cycle):
            yield cur
        for th in self._threads:
            if th is cur:
                continue
            if (th.state == READY and th.pc < th.trace_len
                    and th.busy_until <= cycle):
                yield th

    def _execute(self, cycle: int, th: WGThread, ins: Instr, nid: int = -1):
        if self.san is not None:
            self.san.on_execute(cycle, th, ins)
        op = ins.op
        cta = th.cta
        if op == isa.WGMMA:             # hottest op: dispatched first
            self.tc.push(cycle, th, ins, nid)
        elif op == isa.TMA_TENSOR:
            self.tma.submit_load(cycle, th, ins, nid)
        elif op == isa.TMA_STORE:
            self.tma.submit_store(cycle, th, ins, nid)
        elif op == isa.WGMMA_COMMIT:
            if th.mma_pending:
                self.tc._apply(th, cycle)
            g = th.wgmma_groups.setdefault(ins.gid, [0, 0, False])
            if not g[2]:
                g[2] = True
                if g[1] < g[0]:
                    th.wgmma_out.add(ins.gid)
        elif op == isa.TMA_COMMIT:
            g = th.tma_groups.setdefault(ins.gid, [0, 0, False])
            if not g[2]:
                g[2] = True
                if g[1] < g[0]:
                    th.tma_out.add(ins.gid)
        elif op == isa.RELEASE_STAGE:
            cta.stage_releases[ins.sid] = cta.stage_releases.get(ins.sid, 0) + 1
            self.notify_stage(cta, ins.sid)
        elif op == isa.BAR_ARRIVE:
            cta.bar_arrivals[ins.bid] = cta.bar_arrivals.get(ins.bid, 0) + 1
            self.notify_bar(cta, ins.bid)
        elif op == isa.BUBBLES:
            fl = self.faults
            until = cycle + (ins.cycles if fl is None
                             else fl.stretch(cycle, self.sm_id, ins.cycles))
            th.busy_until = until
            if self.event:
                # park on a per-SM timer: one coalesced wake per (cycle, SM)
                # instead of one broadcast wake_all per bubble
                if th.in_ready:
                    th.in_ready = False
                    self._ready.remove(th)
                lst = self._timers.get(until)
                if lst is None:
                    self._timers[until] = [th]
                    self.evq.wake_at(until, self._timer_fire)
                else:
                    lst.append(th)
            else:
                self.evq.push(until, self.wake_all)
        # waits that reached here had their condition met: no-op

    def _finish_thread(self, th: WGThread):
        th.cta.done_wgs += 1
        self._rebuild_threads()
        if th.cta.done_wgs == len(th.cta.threads):
            self._retire_cta(th.cta)

    def _retire_cta(self, cta: CTA):
        self.ctas.remove(cta)
        self._rebuild_threads()
        self.engine.cta_retired(self, cta)

    def all_blocked(self, cycle: int) -> bool:
        for th in self._threads:
            if (th.state == READY and th.pc < th.trace_len
                    and th.busy_until <= cycle):
                return False
        return True

    def unstall(self):
        """Re-mark stalled threads READY so conditions get re-checked.
        Broadcast-mode fallback only — waiter mode wakes via the index."""
        for th in self._threads:
            if th.state == STALLED:
                th.state = READY


class Engine:
    """Top level: CTA dispatcher + global cycle loop (Algorithm 1)."""

    SCHEDULERS = ("event", "waiter", "broadcast")
    MEM_FIDELITIES = ("line", "tile")

    def __init__(self, machine: GPUMachine, n_sms: Optional[int] = None,
                 mem_scale: Optional[float] = None, record_gantt: bool = False,
                 seed: int = 0, direct_hbm: bool = False, tracer=None,
                 broadcast_wake: bool = False,
                 scheduler: Optional[str] = None,
                 counters=None, sanitize: bool = False,
                 faults=None, watchdog=None,
                 mem_fidelity: str = "line"):
        if scheduler is None:
            scheduler = "broadcast" if broadcast_wake else "event"
        elif scheduler not in self.SCHEDULERS:
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             f"expected one of {self.SCHEDULERS}")
        elif broadcast_wake and scheduler != "broadcast":
            raise ValueError("broadcast_wake=True conflicts with "
                             f"scheduler={scheduler!r}")
        if mem_fidelity not in self.MEM_FIDELITIES:
            raise ValueError(f"unknown mem_fidelity {mem_fidelity!r}; "
                             f"expected one of {self.MEM_FIDELITIES}")
        self.scheduler = scheduler
        self.mem_fidelity = mem_fidelity
        self.cfg = machine
        self.n_sms = n_sms or machine.num_sms
        scale = mem_scale if mem_scale is not None else self.n_sms / machine.num_sms
        self.evq = EventQueue()
        self.lrc, self.l2, self.dram = build_memory(machine, self.evq, scale,
                                                    seed, direct=direct_hbm,
                                                    tile=mem_fidelity == "tile")
        self.tmaps: Dict[int, TensorMap] = {}
        self.tile_cache: Dict[tuple, list] = {}   # (map_id, origin) -> lines
        self.tile_seen: set = set()               # keys seen exactly once
        if tracer is None and record_gantt:
            # gantt is now a view over the structured event trace
            from repro_torch.analysis.events import EventTracer
            tracer = EventTracer()
        self.tracer = tracer
        self.record_gantt = tracer is not None
        # opt-in PM-counter sink (obs.counters.CounterSink).  The run loops
        # only ever *read* engine state through it at window boundaries, so
        # attaching one cannot change simulated behavior (bit-neutrality is
        # enforced in tests/test_engine_equiv.py); when None the cost is a
        # single is-None test per loop iteration.
        self.counters = counters
        # opt-in runtime hazard sanitizer (analysis.hazards): TSan-style
        # per-event cross-check of the ring protocol, read-only over
        # simulated state like the counter sink, so bit-neutral by the
        # same argument; when off the cost is one is-None test per issue
        self.sanitizer = None
        if sanitize:
            from repro_torch.analysis.hazards import HazardSanitizer
            self.sanitizer = HazardSanitizer()
        # populated by analysis.hazards.explain_deadlock the moment a run
        # loop concludes nothing can ever progress again (deadlocked=True);
        # deliberately NOT part of stats() — diagnostics, not simulation
        self.deadlock_info: Optional[dict] = None
        # opt-in seeded fault/variability session (repro_torch.faults): latency
        # jitter, SM slowdown/offlining, throttle windows, delayed async
        # completions.  Same hook discipline as the counter sink: every
        # site costs one is-None test when off, and an identity plan draws
        # +0 extra cycles everywhere, so attaching it is bit-exact.  The
        # session's RNG is private — the engine RNG stream is untouched.
        self.faults = None
        if faults is not None:
            from repro_torch.faults.session import make_session
            self.faults = make_session(faults, self.n_sms)
            fl = self.faults
            self.dram.faults = fl
            self.lrc.faults = fl
            if self.l2 is not self.lrc:     # sliced L2 (not DirectHBM)
                self.l2.faults = fl
                for sl in self.l2.slices:
                    sl.faults = fl
        # opt-in run watchdog (repro_torch.faults.watchdog): wall-clock /
        # sim-cycle budgets with clean abort + partial-result salvage.
        # Read-only over simulated state; a run that finishes under budget
        # is bit-exact with an unwatched run.
        self.watchdog = None
        if watchdog is not None:
            from repro_torch.faults.watchdog import make_watchdog
            self.watchdog = make_watchdog(watchdog)
        self.aborted = False
        self.abort_info: Optional[dict] = None
        self.broadcast_wake = scheduler == "broadcast"
        self.sms = [SM(i, machine, self) for i in range(self.n_sms)]
        self.pending: deque = deque()
        self.cycle = 0
        self.launched = 0
        self.retired = 0
        self.deadlocked = False
        self._active = set(range(self.n_sms))
        # event mode: the active set is a maintained ordered structure —
        # sorted list of active sm ids plus a membership flag per SM: the
        # run loop sweeps a tuple snapshot in ascending-id order, and in
        # steady state (every swept SM still issue-eligible) pays zero
        # maintenance — wakes insort (rare), removals trigger one rebuild
        self._active_list: List[int] = list(range(self.n_sms))
        self._active_flags = bytearray([1]) * self.n_sms

    # ------------------------------------------------------------------
    def define_tmap(self, tm: TensorMap):
        self.tmaps[tm.map_id] = tm

    def launch(self, ctas: List[CTATrace]):
        self.pending.extend(ctas)
        self._dispatch()

    def _dispatch(self, parent: Optional[int] = None):
        fl = self.faults
        off = fl.offline if fl is not None and fl.offline else None
        for sm in self.sms:
            if off is not None and sm.sm_id in off:
                continue                 # fenced/dead SM: no CTAs dispatched
            added = False
            while self.pending and sm.has_slot():
                trace = self.pending.popleft()
                cta = CTA(trace, self.launched)
                self.launched += 1
                sm.ctas.append(cta)
                for th in cta.threads:
                    th.sm = sm
                    if sm.event:
                        th.in_ready = True
                        insort(sm._ready, th, key=_ORDER)
                added = True
                if self.tracer is not None:
                    self.tracer.on_dispatch(cta.idx, parent)
                self.mark_active(sm)
            if added:
                sm._rebuild_threads()

    def cta_retired(self, sm: SM, cta: CTA):
        self.retired += 1
        if self.sanitizer is not None:
            self.sanitizer.on_cta_retired(self.cycle, cta)
        self._dispatch(parent=cta.idx)

    def mark_active(self, sm: SM):
        if sm.event:
            sid = sm.sm_id
            if not self._active_flags[sid]:
                self._active_flags[sid] = 1
                insort(self._active_list, sid)
            return
        self._active.add(sm.sm_id)
        if self.broadcast_wake:
            sm.unstall()

    # ------------------------------------------------------------------
    def run(self, max_cycles: int = 2_000_000_000) -> dict:
        if self.scheduler == "event":
            return self._run_event(max_cycles)
        broadcast = self.broadcast_wake
        active = self._active
        sms = self.sms
        evq = self.evq
        snk = self.counters
        wd = self.watchdog
        while self.cycle < max_cycles:
            evq.pop_ready(self.cycle)
            if snk is not None and self.cycle >= snk.next_sample:
                snk.sample(self.cycle, self)
            if self.retired == self.launched and not self.pending:
                break
            if wd is not None and wd.tripped(self.cycle):
                self._abort(wd)
                break
            progressed = False
            if active:
                # ascending sm id == the insertion-ordered small-int set
                # iteration the broadcast engine always produced
                for sid in sorted(active):
                    sm = sms[sid]
                    if sm.step(self.cycle):
                        progressed = True
                        sm.issue_cycles += 1
                    elif sm.all_blocked(self.cycle):
                        active.discard(sid)
            if progressed:
                self.cycle += 1
                continue
            nxt = evq.next_cycle()
            if nxt is None:
                # threads may be waiting on busy_until (bubbles) -- find min
                wake = [th.busy_until for sm in sms for th in sm.threads()
                        if th.state == READY and not th.done()
                        and th.busy_until > self.cycle]
                if not wake:
                    self._flag_deadlock()
                    break
                self.cycle = min(wake) if wd is None else wd.clamp(min(wake))
                for sm in sms:
                    self.mark_active(sm)
            else:
                nxt = max(self.cycle + 1, nxt)
                self.cycle = nxt if wd is None else wd.clamp(nxt)
                if broadcast:
                    # legacy rescan: re-mark every SM after each time jump
                    for sm in sms:
                        self.mark_active(sm)
        if snk is not None:
            snk.finish(self.cycle, self)
        return self.stats()

    def _run_event(self, max_cycles: int) -> dict:
        """Discrete-event run loop (default scheduler).

        Time advances straight to the next interesting cycle: the event-queue
        head (memory completions, busy-timer wakes, thread retirements) or
        the next cycle any SM can issue.  Nothing here scans threads:
        ``sm._ready`` is the maintained per-SM issue-eligible queue, the
        active set is a flag-guarded min-heap of SM ids drained in ascending
        order, and busy_until sleepers wake via coalesced per-SM timers —
        there is no broadcast wake and no O(threads) busy-scan fallback.

        The snapshot discipline matches the legacy loop exactly: the set of
        SMs stepped in a cycle is fixed before any of them steps, so an SM
        woken mid-sweep first issues on the following cycle."""
        sms = self.sms
        evq = self.evq
        evh = evq._h     # heap head probed inline: most cycles drain nothing
        lst = self._active_list
        flags = self._active_flags
        snk = self.counters
        wd = self.watchdog
        while self.cycle < max_cycles:
            if evh and evh[0] <= self.cycle:
                evq.pop_ready(self.cycle)
            if snk is not None and self.cycle >= snk.next_sample:
                snk.sample(self.cycle, self)
            if self.retired == self.launched and not self.pending:
                break
            if wd is not None and wd.tripped(self.cycle):
                self._abort(wd)
                break
            progressed = False
            if lst:
                # snapshot discipline: only SMs active at cycle start are
                # swept (ascending sm id); mid-sweep wakes insort into lst
                # and issue next cycle.  A removal transiently leaves its
                # stale entry in lst (flag 0), so a re-wake within the same
                # sweep can duplicate it — the rebuild below dedups.
                snapshot = tuple(lst)
                removed = False
                for sid in snapshot:
                    sm = sms[sid]
                    if sm._ready:
                        if sm.step(self.cycle):
                            progressed = True
                            sm.issue_cycles += 1
                        if not sm._ready:
                            flags[sid] = 0
                            removed = True
                    else:
                        flags[sid] = 0
                        removed = True
                if removed:
                    seen = set()
                    keep = []
                    for sid in lst:
                        if flags[sid] and sid not in seen:
                            seen.add(sid)
                            keep.append(sid)
                    lst[:] = keep
            if progressed:
                self.cycle += 1
                continue
            nxt = evq.next_cycle()
            if nxt is None:
                # no issuable thread, no pending event: nothing can ever
                # make progress again (busy sleepers hold queue timers)
                self._flag_deadlock()
                break
            nxt = max(self.cycle + 1, nxt)
            self.cycle = nxt if wd is None else wd.clamp(nxt)
        if snk is not None:
            snk.finish(self.cycle, self)
        return self.stats()

    # ------------------------------------------------------------------
    def _abort(self, wd):
        """Watchdog trip: break the run loop cleanly and salvage a partial
        result (CTA census, blocked-thread snapshot, fault stats) instead
        of hanging or dying.  Counters still get their finish() sample —
        the loops run it after the break — so PM timelines up to the abort
        survive too."""
        from repro_torch.faults.watchdog import salvage
        self.aborted = True
        self.abort_info = salvage(self, wd.reason, wd.wall_s())

    def _flag_deadlock(self):
        """Both run loops land here when nothing can ever progress again.
        Attaches the wait-for-graph explanation (which thread blocks on
        which sid/bid, witness cycle) instead of just flipping the bool;
        runs after the loop already decided to break, so it cannot perturb
        simulated state."""
        self.deadlocked = self.retired < self.launched
        if self.deadlocked:
            from repro_torch.analysis.hazards import explain_deadlock
            self.deadlock_info = explain_deadlock(self)

    def stats(self) -> dict:
        l2 = self.l2.stats()
        tc_busy = sum(sm.tc.busy_cycles for sm in self.sms)
        return {
            "cycles": self.cycle,
            "time_us": self.cycle / (self.cfg.freq_ghz * 1e3),
            "ctas": self.retired,
            "l2": l2,
            "l2_req_bytes": l2["requests"] * self.cfg.line_bytes,
            "dram_bytes": self.dram.bytes_served,
            "lrc_merged": self.lrc.merged,
            "tma_lines": sum(sm.tma.lines_issued for sm in self.sms),
            "tc_busy_cycles": tc_busy,
            "tc_util": tc_busy / max(1, self.cycle * self.n_sms),
        }

    def gantt(self) -> List[Tuple[str, int, int]]:
        """Legacy flat-interval view, derived from the structured trace."""
        if self.tracer is None:
            return []
        from repro_torch.core.gantt import from_events
        return from_events(self.tracer.events)
