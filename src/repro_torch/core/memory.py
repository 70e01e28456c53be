"""Sim-FA memory hierarchy: LRC coalescer -> sliced L2 -> DRAM channels.

Models the timing-visible structures of the paper's §4.3/§5.4:
  * L2 Request Coalescer (LRC): merges duplicate in-flight line requests
    across each SM pair before they reach L2 (Table 5: no-LRC ablation).
  * 80-slice L2, XOR hash ``slice = (line ^ (line >> 5)) % N`` (Table 5:
    oversimplified-hash ablation uses the low bits instead).
  * per-slice MSHRs (merge misses to the same line; stall when full),
    near/far partition latency, write-back/write-allocate, alloc-on-fill.
  * RemoteCopy proxy: far-partition hits probabilistically insert a shadow
    line into the near partition, competing for capacity (paper Fig. 3).
  * DRAM: per-channel queues at HBM aggregate bandwidth + fixed latency
    (bandwidth/latency model in lieu of Ramulator; DESIGN.md §8).

All requests are 128B lines. Completion is callback-based: the engine hands
``(line_addr, sm_id, callback)``; the callback fires at absorb time.
"""
from __future__ import annotations

import heapq
import random
from collections import OrderedDict, defaultdict, deque
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.machine import GPUMachine


class EventQueue:
    """Shared simulation event queue, bucketed by cycle.

    Events land in per-cycle lists with a heap holding one entry per
    *distinct* pending cycle, so the common case — many completions at the
    same cycle — costs a list append instead of a heap sift.  Same-cycle
    events fire in push order, which is exactly the ``(cycle, seq)`` order
    the previous flat heap produced; callbacks that push new events at the
    cycle currently draining are picked up within the same drain (the flat
    heap's ``<= cycle`` semantics).

    ``wake_at`` is the coalesced timer-wake primitive: no matter how many
    threads park on the same ``(cycle, waker)``, exactly one event fires —
    ``waker(cycle)`` — letting a scheduler park whole groups of
    ``busy_until`` threads on one targeted timer instead of one broadcast
    wake per thread.
    """

    def __init__(self):
        self._h: List[int] = []          # pending cycles (one entry each)
        self._buckets: Dict[int, list] = {}
        self.now = 0            # cycle of the event currently executing
        self.popped = 0         # total events executed (sim throughput stat)
        self._wakes: set = set()         # live (cycle, waker) timer keys

    def push(self, cycle: int, fn: Callable, *args):
        b = self._buckets.get(cycle)
        if b is None:
            self._buckets[cycle] = b = []
            heapq.heappush(self._h, cycle)
        b.append((fn, args))

    def wake_at(self, cycle: int, waker: Callable):
        """Schedule ``waker(cycle)`` at ``cycle``, coalescing duplicates:
        repeated requests for the same (cycle, waker) are one event."""
        key = (cycle, waker)
        if key in self._wakes:
            return
        self._wakes.add(key)
        self.push(cycle, self._fire_wake, key)

    def _fire_wake(self, key):
        self._wakes.discard(key)
        key[1](key[0])

    def pop_ready(self, cycle: int):
        h = self._h
        buckets = self._buckets
        while h and h[0] <= cycle:
            t = heapq.heappop(h)
            self.now = t
            lst = buckets[t]
            i = 0
            while i < len(lst):     # callbacks may append to this bucket
                fn, args = lst[i]
                i += 1
                fn(*args)
            self.popped += i
            del buckets[t]

    def next_cycle(self) -> Optional[int]:
        return self._h[0] if self._h else None

    def __len__(self):
        return sum(len(b) for b in self._buckets.values())


class DRAM:
    """Per-channel queueing bandwidth/latency model."""

    def __init__(self, cfg: GPUMachine, evq: EventQueue, scale: float = 1.0):
        self.cfg = cfg
        self.evq = evq
        n = max(1, int(round(cfg.dram_channels * scale)))
        self.channels = n
        self.free_at = [0] * n          # next cycle each channel can start
        self.service = cfg.dram_line_service_cycles
        self.bytes_served = 0
        self.busy_cycles = 0.0          # channel-occupied cycles (observable
                                        # only: feeds obs counter timelines)
        self.faults = None              # repro_torch.faults.FaultSession hook

    def access(self, cycle: int, line: int, cb: Callable):
        ch = (line // self.cfg.line_bytes) % self.channels
        start = max(cycle, self.free_at[ch])
        self.free_at[ch] = start + self.service
        self.bytes_served += self.cfg.line_bytes
        self.busy_cycles += self.service
        fl = self.faults
        lat = (self.cfg.dram_latency if fl is None
               else self.cfg.dram_latency + fl.dram_extra())
        self.evq.push(int(start + self.service + lat), cb)


class L2Slice:
    """One L2 slice: LRU tags + MSHRs + near/far latency."""

    def __init__(self, sid: int, cfg: GPUMachine, dram: DRAM, evq: EventQueue,
                 lines_capacity: int):
        self.sid = sid
        self.cfg = cfg
        self.dram = dram
        self.evq = evq
        self.capacity = max(16, lines_capacity)
        self.tags: "OrderedDict[int, bool]" = OrderedDict()  # line -> dirty
        self.mshr: Dict[int, List[Callable]] = {}
        self.stalled: deque = deque()   # requests waiting for an MSHR
        # stats
        self.hits = 0
        self.misses = 0
        self.mshr_merges = 0
        self.rc_inserts = 0
        self.mshr_peak = 0              # high-water outstanding misses
                                        # (observable only: MSHR pressure)
        self.faults = None              # repro_torch.faults.FaultSession hook

    @property
    def occupancy(self) -> float:
        return len(self.tags) / self.capacity

    def _insert(self, line: int, dirty: bool = False):
        if line in self.tags:
            self.tags.move_to_end(line)
            return
        self.tags[line] = dirty
        if len(self.tags) > self.capacity:
            self.tags.popitem(last=False)   # LRU evict (write-back not timed)

    def access(self, cycle: int, line: int, far: bool, cb: Callable,
               write: bool = False):
        # a full MSHR pool stalls the whole request path for this slice
        # (head-of-line blocking): hits behind the stall wait too (§4.3,
        # "once it fills, no new misses can be issued to DRAM")
        if self.stalled:
            self.stalled.append((line, far, cb, write))
            return
        self._access(cycle, line, far, cb, write)

    def _access(self, cycle: int, line: int, far: bool, cb: Callable,
                write: bool = False):
        lat = self.cfg.l2_far_latency if far else self.cfg.l2_near_latency
        fl = self.faults
        if fl is not None:
            lat += fl.l2_extra(far)
        if line in self.tags:
            self.hits += 1
            self.tags.move_to_end(line)
            if write:
                self.tags[line] = True
            self.evq.push(cycle + lat, cb)
            return
        # miss
        if line in self.mshr:               # MSHR hit: merge
            self.mshr_merges += 1
            self.mshr[line].append(cb)
            return
        if len(self.mshr) >= self.cfg.l2_mshr_per_slice:
            self.stalled.append((line, far, cb, write))
            return
        self.misses += 1
        self.mshr[line] = [cb]
        if len(self.mshr) > self.mshr_peak:
            self.mshr_peak = len(self.mshr)

        def fill():
            self._insert(line, dirty=write)      # alloc-on-fill
            waiters = self.mshr.pop(line, [])
            for w in waiters:
                w()
            # drain the stalled request path now that an MSHR freed up
            while self.stalled and len(self.mshr) < self.cfg.l2_mshr_per_slice:
                l2, f2, c2, w2 = self.stalled.popleft()
                self._access(self.evq.now, l2, f2, c2, w2)

        self.dram.access(cycle + lat, line, fill)


class L2Cache:
    """Sliced L2 with XOR hash, two partitions, and the RemoteCopy proxy."""

    def __init__(self, cfg: GPUMachine, dram: DRAM, evq: EventQueue,
                 scale: float = 1.0, seed: int = 0):
        self.cfg = cfg
        self.evq = evq
        n = max(2, int(round(cfg.l2_slices * scale)))
        per_slice_lines = int(cfg.l2_bytes * scale) // cfg.line_bytes // n
        self.slices = [L2Slice(i, cfg, dram, evq, per_slice_lines)
                       for i in range(n)]
        self.n = n
        self.rng = random.Random(seed)
        self.requests = 0
        self.faults = None              # repro_torch.faults.FaultSession hook

    def slice_of(self, line_addr: int) -> int:
        line = line_addr // self.cfg.line_bytes
        if self.cfg.xor_hash:
            return (line ^ (line >> 5)) % self.n
        return line % self.n           # ablation: low bits only

    def access(self, cycle: int, line_addr: int, sm_id: int, cb: Callable,
               write: bool = False):
        self.requests += 1
        s = self.slice_of(line_addr)
        sl = self.slices[s]
        # partition: slices [0, n/2) near SMs [0, num_sms/2), else far
        near_part = 0 if sm_id < self.cfg.num_sms // 2 else 1
        slice_part = 0 if s < self.n // 2 else 1
        far = near_part != slice_part

        if far and self.cfg.remote_copy:
            # behavioral RemoteCopy proxy (§4.3): far lines get mirrored into
            # the requester-side twin slice. Mirrors (a) serve later reads at
            # near latency — the L2-hit floor — and (b) compete with regular
            # lines for capacity, which halves the effective L2 for shared
            # working sets: the 25 MB boundary of §6.2.2 and the 25-50 MB
            # fluctuating transition window of Fig. 3.
            mirror = self.slices[(s + self.n // 2) % self.n]
            if line_addr in mirror.tags:
                if write:
                    mirror.tags.pop(line_addr, None)   # keep mirrors clean
                else:
                    mirror.hits += 1
                    mirror.tags.move_to_end(line_addr)
                    fl = self.faults
                    lat = (self.cfg.l2_near_latency if fl is None
                           else self.cfg.l2_near_latency + fl.l2_extra(False))
                    self.evq.push(cycle + lat, cb)
                    return
            elif (not write and line_addr in sl.tags
                  and mirror.occupancy < self.cfg.rc_occupancy_threshold
                  and self.rng.random() < self.cfg.rc_max_prob):
                mirror._insert(line_addr)
                mirror.rc_inserts += 1
        sl.access(cycle, line_addr, far, cb, write)

    # stats -----------------------------------------------------------------
    def stats(self):
        agg = defaultdict(int)
        for sl in self.slices:
            agg["hits"] += sl.hits
            agg["misses"] += sl.misses
            agg["mshr_merges"] += sl.mshr_merges
            agg["rc_inserts"] += sl.rc_inserts
            if sl.mshr_peak > agg["mshr_peak"]:
                agg["mshr_peak"] = sl.mshr_peak
        agg["requests"] = self.requests
        return dict(agg)


class LRC:
    """L2 Request Coalescer: merges duplicate outstanding line requests from
    an SM pair (paper §5.4). Without it every CTA's TMA traffic reaches L2."""

    def __init__(self, cfg: GPUMachine, l2: L2Cache):
        self.cfg = cfg
        self.l2 = l2
        # key -> single waiter callable, promoted to a list on first merge
        # (the single-waiter case is ~all of them; skipping the list saves
        # an allocation per line on the hot path)
        self.pending: Dict[Tuple[int, int], object] = {}
        self.merged = 0
        # line -> (home slice, home partition, mirror slice), lazily built:
        # the slice hash and partition of a line never change, so the hot
        # path pays one dict hit instead of recomputing hash + partition
        self._meta: Dict[int, tuple] = {}
        self.faults = None              # repro_torch.faults.FaultSession hook
        # machine constants hoisted off cfg: read once per request, not via
        # an attribute chain
        self._enabled = cfg.lrc_enabled
        self._near = cfg.l2_near_latency
        self._far = cfg.l2_far_latency
        self._rc = cfg.remote_copy
        self._rc_thresh = cfg.rc_occupancy_threshold
        self._rc_prob = cfg.rc_max_prob
        self._half_sms = cfg.num_sms // 2

    def request(self, cycle: int, line_addr: int, sm_id: int, cb: Callable,
                write: bool = False):
        self.request_many(cycle, (line_addr,), sm_id, cb, write)

    def _line_meta(self, line_addr: int):
        l2 = self.l2
        s = l2.slice_of(line_addr)
        m = (l2.slices[s], 0 if s < l2.n // 2 else 1,
             l2.slices[(s + l2.n // 2) % l2.n])
        self._meta[line_addr] = m
        return m

    def request_many(self, cycle: int, lines, sm_id: int, cb: Callable,
                     write: bool = False):
        """Batch entry point: one call per TMA issue cycle, one shared ``cb``
        invoked once per completed line (the engine's per-job counter).

        The read path inlines the L2 hit handling (including the RemoteCopy
        mirror probe, preserving the exact RNG draw sequence) so the
        steady-state K/V re-stream — an L2 hit per line — costs a couple of
        dict probes and a bucket append instead of the full
        ``L2Cache.access`` call chain.  Misses, MSHR pressure and stalled
        slices fall back to the unfused slow path."""
        if not self._enabled or write:
            l2 = self.l2
            for line_addr in lines:
                l2.access(cycle, line_addr, sm_id, cb, write)
            return
        l2 = self.l2
        pending = self.pending
        meta = self._meta
        evq = l2.evq
        fanout = self._fanout
        pair = sm_id // 2
        req_part = 0 if sm_id < self._half_sms else 1
        rc = self._rc
        near_lat = self._near
        far_lat = self._far
        rc_thresh = self._rc_thresh
        rc_prob = self._rc_prob
        rng = l2.rng.random
        fl = self.faults       # fused L2-hit paths bypass L2Slice._access,
                               # so the jitter hook is applied inline here
        for line_addr in lines:
            key = (pair, line_addr)
            waiters = pending.get(key)
            if waiters is not None:
                self.merged += 1
                if waiters.__class__ is list:
                    waiters.append(cb)
                else:
                    pending[key] = [waiters, cb]
                continue
            pending[key] = cb
            l2.requests += 1
            m = meta.get(line_addr)
            if m is None:
                m = self._line_meta(line_addr)
            sl, home_part, mirror = m
            if home_part == req_part:                       # near access
                if not sl.stalled and line_addr in sl.tags:
                    sl.hits += 1
                    sl.tags.move_to_end(line_addr)
                    lat = (near_lat if fl is None
                           else near_lat + fl.l2_extra(False))
                    evq.push(cycle + lat, fanout, key)
                    continue
                sl.access(cycle, line_addr, False, partial(fanout, key))
                continue
            if rc:                     # far read: RemoteCopy proxy (§4.3)
                mtags = mirror.tags
                if line_addr in mtags:
                    mirror.hits += 1
                    mtags.move_to_end(line_addr)
                    lat = (near_lat if fl is None
                           else near_lat + fl.l2_extra(False))
                    evq.push(cycle + lat, fanout, key)
                    continue
                if (line_addr in sl.tags
                        and mirror.occupancy < rc_thresh
                        and rng() < rc_prob):
                    mirror._insert(line_addr)
                    mirror.rc_inserts += 1
            if not sl.stalled and line_addr in sl.tags:
                sl.hits += 1
                sl.tags.move_to_end(line_addr)
                lat = (far_lat if fl is None
                       else far_lat + fl.l2_extra(True))
                evq.push(cycle + lat, fanout, key)
                continue
            sl.access(cycle, line_addr, True, partial(fanout, key))

    def request_one(self, cycle: int, line_addr: int, sm_id: int,
                    cb: Callable, write: bool = False):
        """Single-line fast entry — the TMA engines' targeted-refill path
        (one replacement line per completed line, see engine.TMAEngine)."""
        if not self._enabled or write:
            self.l2.access(cycle, line_addr, sm_id, cb, write)
            return
        key = (sm_id // 2, line_addr)
        pending = self.pending
        waiters = pending.get(key)
        if waiters is not None:
            self.merged += 1
            if waiters.__class__ is list:
                waiters.append(cb)
            else:
                pending[key] = [waiters, cb]
            return
        pending[key] = cb
        l2 = self.l2
        l2.requests += 1
        m = self._meta.get(line_addr)
        if m is None:
            m = self._line_meta(line_addr)
        sl, home_part, mirror = m
        fanout = self._fanout
        fl = self.faults
        if home_part == (0 if sm_id < self._half_sms else 1):
            if not sl.stalled and line_addr in sl.tags:
                sl.hits += 1
                sl.tags.move_to_end(line_addr)
                lat = (self._near if fl is None
                       else self._near + fl.l2_extra(False))
                l2.evq.push(cycle + lat, fanout, key)
                return
            sl.access(cycle, line_addr, False, partial(fanout, key))
            return
        if self._rc:
            mtags = mirror.tags
            if line_addr in mtags:
                mirror.hits += 1
                mtags.move_to_end(line_addr)
                lat = (self._near if fl is None
                       else self._near + fl.l2_extra(False))
                l2.evq.push(cycle + lat, fanout, key)
                return
            if (line_addr in sl.tags
                    and mirror.occupancy < self._rc_thresh
                    and l2.rng.random() < self._rc_prob):
                mirror._insert(line_addr)
                mirror.rc_inserts += 1
        if not sl.stalled and line_addr in sl.tags:
            sl.hits += 1
            sl.tags.move_to_end(line_addr)
            lat = (self._far if fl is None
                   else self._far + fl.l2_extra(True))
            l2.evq.push(cycle + lat, fanout, key)
            return
        sl.access(cycle, line_addr, True, partial(fanout, key))

    def _fanout(self, key):
        w = self.pending.pop(key, None)
        if w is None:
            return
        if w.__class__ is list:
            for f in w:
                f()
        else:
            w()


class DirectHBM:
    """TPU-mode memory front end: no shared L2 between cores and HBM —
    requests go straight to the DRAM channel model plus a fixed latency."""

    def __init__(self, cfg: GPUMachine, dram: DRAM, evq: EventQueue):
        self.cfg = cfg
        self.dram = dram
        self.evq = evq
        self.merged = 0
        self.requests = 0

    def request(self, cycle: int, line_addr: int, sm_id: int, cb: Callable,
                write: bool = False):
        self.requests += 1
        self.dram.access(cycle, line_addr, cb)

    request_one = request

    def request_many(self, cycle: int, lines, sm_id: int, cb: Callable,
                     write: bool = False):
        self.requests += len(lines)
        dram = self.dram
        for line_addr in lines:
            dram.access(cycle, line_addr, cb)

    def stats(self):
        return {"requests": self.requests, "hits": 0, "misses": self.requests,
                "mshr_merges": 0, "rc_inserts": 0, "mshr_peak": 0}


class TileMemory:
    """Tile-granular memory front end (``Engine(mem_fidelity="tile")``).

    Collapses a TMA tile's ``tile_lines`` per-line cache events into ONE
    bulk transaction: residency, slice-partition distribution, merge
    windows and DRAM channel occupancy are charged at tile granularity and
    the whole tile completes with a single EventQueue callback, instead of
    per-line LRC/MSHR/refill bookkeeping (docs/fidelity.md).

    Byte-exact vs. the line-exact hierarchy (asserted by
    ``tests/test_engine_equiv.py`` and ``benchmarks/bench_fidelity.py``):
    ``dram_bytes``, ``tma_lines``, and L2 ``misses`` — these are structural
    (the set of first-touched lines), not timing-dependent.  Approximated:
    request/merge *split* (line-exact merge windows depend on sub-cycle
    event interleaving — see docs/fidelity.md for why byte-identical
    post-coalescer traffic is unattainable at tile granularity) and all
    latencies, which come from a streaming service model (issue rate +
    in-flight cap + blended near/far latency) over the same machine
    constants, validated to the documented cycle-error bound.

    State is O(tiles): a tile-granular LRU with per-tile slice-partition
    counts, lazily-expired fill/merge windows (no cleanup events), and the
    shared per-channel DRAM ``free_at`` model charged in bulk.
    """

    def __init__(self, cfg: GPUMachine, dram: DRAM, evq: EventQueue,
                 scale: float = 1.0, seed: int = 0):
        self.cfg = cfg
        self.dram = dram
        self.evq = evq
        self.rng = random.Random(seed)   # RC mirror draws (tile-granular)
        n = max(2, int(round(cfg.l2_slices * scale)))
        self._nsl = n
        self._half_slice = n // 2
        self.capacity = max(16, int(cfg.l2_bytes * scale) // cfg.line_bytes)
        # tile key -> [distinct_line_list, part0_lines, part1_lines, m0, m1]
        # (m0/m1: RemoteCopy mirror present for requesters in partition 0/1)
        self.tiles: "OrderedDict[tuple, list]" = OrderedDict()
        # line -> number of resident tiles containing it.  Tiles of different
        # tensor maps can OVERLAP (unclamped boxes spill across region
        # boundaries), so misses/dram_bytes must be counted per line, not
        # per tile — this is what keeps them byte-identical to line-exact.
        self.line_ref: Dict[int, int] = {}
        self.mirror_lines = 0           # RC mirror capacity pressure
        self.fill_done: Dict[tuple, Tuple[int, int]] = {}  # key -> (t, lines)
        # (pair, key) -> merge window (issue start, stream end)
        self.pending: Dict[tuple, Tuple[int, int]] = {}
        # per-SM TMA port: aggregate issue-slot occupancy (lines_per_cycle)
        self.port_free: Dict[int, int] = {}
        # stats: same schema as L2Cache.stats() + LRC.merged, all in lines
        self.hits = 0
        self.misses = 0
        self.mshr_merges = 0
        self.rc_inserts = 0
        self.mshr_peak = 0
        self.requests = 0
        self.merged = 0
        self.faults = None              # repro_torch.faults.FaultSession hook
        # hot machine constants
        self._lb = cfg.line_bytes
        self._xor = cfg.xor_hash
        self._lpc = cfg.tma_lines_per_cycle
        self._cap = cfg.tma_max_inflight_lines
        self._near = cfg.l2_near_latency
        self._far = cfg.l2_far_latency
        self._dram_lat = cfg.dram_latency
        self._half_sms = cfg.num_sms // 2
        self._lrc_on = cfg.lrc_enabled
        self._dedup = cfg.tma_dedup
        self._rc = cfg.remote_copy
        self._rc_thresh = cfg.rc_occupancy_threshold
        self._rc_prob = cfg.rc_max_prob

    # ------------------------------------------------------------------
    def _stream(self, base: int, n: int, lam: int) -> int:
        """Completion cycle of an n-line stream starting at ``base``: issue
        at ``tma_lines_per_cycle``, at most ``tma_max_inflight_lines``
        outstanding at per-line latency ``lam`` (Little's-law throughput
        when the cap binds), plus the last line's latency."""
        tail = (n - 1) // self._lpc
        c = self._cap
        if n > c:
            alt = (n - c) * lam // c
            if alt > tail:
                tail = alt
        return base + tail + lam

    def _part_counts(self, lines) -> Tuple[int, int]:
        """Count distinct lines homed in each L2 partition (XOR slice hash,
        slices [0, n/2) = partition 0) — computed once per resident tile."""
        n = self._nsl
        half = self._half_slice
        lb = self._lb
        p0 = 0
        if self._xor:
            for la in lines:
                ln = la // lb
                if (ln ^ (ln >> 5)) % n < half:
                    p0 += 1
        else:
            for la in lines:
                if (la // lb) % n < half:
                    p0 += 1
        return p0, len(lines) - p0

    @property
    def resident_lines(self) -> int:
        return len(self.line_ref) + self.mirror_lines

    def _evict(self, cycle: int):
        tiles = self.tiles
        fd = self.fill_done
        ref = self.line_ref
        cap = self.capacity
        scanned = 0
        while len(ref) + self.mirror_lines > cap and scanned < len(tiles):
            key = next(iter(tiles))
            w = fd.get(key)
            if w is not None and w[0] > cycle:
                # still filling: its lines are MSHR-held in line-exact mode,
                # so eviction can't reach them — skip (keeps dram_bytes exact)
                tiles.move_to_end(key)
                scanned += 1
                continue
            ent = tiles.pop(key)
            fd.pop(key, None)
            for la in ent[0]:
                c = ref[la]
                if c == 1:
                    del ref[la]
                else:
                    ref[la] = c - 1
            if ent[3]:
                self.mirror_lines -= ent[2]
            if ent[4]:
                self.mirror_lines -= ent[1]

    # ------------------------------------------------------------------
    def transact(self, cycle: int, lines, sm_id: int, write: bool) -> int:
        """Charge one TMA tile as a single bulk transaction; returns the
        cycle the whole tile completes (always > ``cycle``)."""
        n = len(lines)
        key = (lines[0], lines[-1], n)
        fl = self.faults
        port = self.port_free
        base = port.get(sm_id, 0)
        if base < cycle:
            base = cycle
        # the tile consumes n issue slots of this SM's TMA port (the
        # work-conserving view of the per-cycle line budget)
        port[sm_id] = base + (n + self._lpc - 1) // self._lpc

        # Coalescer merge window: a pair-mate streaming the same tile while
        # the original's stream is still in flight merges whole.  Line-exact
        # merging is per *line* (only lines still pending merge; the rest
        # re-request as hits), but both streams issue at the same per-cycle
        # rate, so merged completions track the original's and the race
        # offset stays constant — whole-window all-merge is the closest
        # tile-granular analogue.  The residual split error is measured per
        # cell by benchmarks/bench_fidelity.py and documented in
        # docs/fidelity.md (largest on tiny launches, where a handful of
        # mis-merged tiles is a big fraction of a small request count).
        if self._lrc_on and not write:
            pkey = (sm_id // 2, key)
            prev = self.pending.get(pkey)
            if prev is not None and prev[1] > cycle:
                self.merged += n
                t = self._stream(base, n, 0)
                if t < prev[1]:
                    t = prev[1]
                return t
        else:
            pkey = None

        nd = n if self._dedup else len(set(lines))
        if self._lrc_on and not write:
            self.requests += nd
            self.merged += n - nd       # intra-tile duplicates coalesce
        else:
            self.requests += n
        part = 0 if sm_id < self._half_sms else 1

        ent = self.tiles.get(key)
        filling = None
        if ent is not None:
            w = self.fill_done.get(key)
            if w is not None:
                if w[0] > cycle:
                    filling = w[0]
                else:
                    del self.fill_done[key]
        if ent is None:
            # first touch (or re-touch after eviction): every line not
            # already resident via an overlapping tile misses — bulk-charge
            # the DRAM channels line by line (channel interleave + queueing
            # preserved), one latency draw per tile
            if self._dedup:
                dl = lines
            else:
                dl = list(dict.fromkeys(lines))
            ref = self.line_ref
            dram = self.dram
            free = dram.free_at
            nch = dram.channels
            svc = dram.service
            lb = self._lb
            t_fill = 0
            nm = 0
            for la in dl:
                c = ref.get(la)
                if c:
                    ref[la] = c + 1
                    continue
                ref[la] = 1
                nm += 1
                ch = (la // lb) % nch
                s = free[ch]
                if s < cycle:
                    s = cycle
                e = s + svc
                free[ch] = e
                if e > t_fill:
                    t_fill = e
            self.misses += nm
            self.hits += nd - nm
            dram.bytes_served += nm * lb
            dram.busy_cycles += nm * svc
            p0, p1 = self._part_counts(dl)
            ent = [dl, p0, p1, 0, 0]
            self.tiles[key] = ent
            self._evict(cycle)
            far = p1 if part == 0 else p0
            lam = (self._near * (nd - far) + self._far * far) // nd
            if fl is not None:
                lam += fl.l2_extra(far > 0)
            if nm:
                # outstanding fill lines across live windows = MSHR pressure
                out = nm
                fd = self.fill_done
                for k in list(fd):
                    w = fd[k]
                    if w[0] <= cycle:
                        del fd[k]
                    else:
                        out += w[1]
                if out > self.mshr_peak:
                    self.mshr_peak = out
                dlat = self._dram_lat if fl is None else \
                    self._dram_lat + fl.dram_extra()
                t_fill += dlat + lam
                fd[key] = (t_fill, nm)
                # per-line slot time blends the missed fraction's DRAM trip
                lam_w = lam + dlat * nm // nd
                t = self._stream(base, nd, lam_w)
                if t < t_fill:
                    t = t_fill
            else:
                lam_w = lam
                t = self._stream(base, nd, lam)
        elif filling is not None:
            # tile fill already in flight from another SM pair: every line
            # merges into the outstanding MSHRs and lands with the fill
            self.mshr_merges += nd
            self.tiles.move_to_end(key)
            lam = self._near if fl is None else self._near + fl.l2_extra(False)
            lam_w = lam
            t = self._stream(base, nd, lam)
            if t < filling + lam:
                t = filling + lam
        else:
            # resident tile: streamed L2 hits at blended near/far latency
            self.hits += nd
            self.tiles.move_to_end(key)
            mirrored = ent[4] if part else ent[3]
            far = 0 if mirrored else (ent[2] if part == 0 else ent[1])
            lam = (self._near * (nd - far) + self._far * far) // nd
            if fl is not None:
                lam += fl.l2_extra(far > 0)
            if (far and not write and self._rc
                    and self.resident_lines < self.capacity * self._rc_thresh
                    and self.rng.random() < self._rc_prob):
                # RemoteCopy proxy at tile granularity: mirror the far half
                # into the requester partition; helps *subsequent* accesses
                # and competes for capacity like line-exact mirrors do
                if part:
                    ent[4] = 1
                else:
                    ent[3] = 1
                self.rc_inserts += far
                self.mirror_lines += far
                self._evict(cycle)
            lam_w = lam
            t = self._stream(base, nd, lam)
        if pkey is not None:
            # completions span [first line's landing, stream end]
            self.pending[pkey] = (base + lam_w, t)
            if len(self.pending) > 4096:    # lazy sweep of expired windows
                self.pending = {k: v for k, v in self.pending.items()
                                if v[1] > cycle}
        return t

    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "mshr_merges": self.mshr_merges,
                "rc_inserts": self.rc_inserts, "mshr_peak": self.mshr_peak,
                "requests": self.requests}


def build_memory(cfg: GPUMachine, evq: EventQueue, scale: float = 1.0,
                 seed: int = 0, direct: bool = False, tile: bool = False):
    dram = DRAM(cfg, evq, scale)
    if direct:
        if tile:
            raise ValueError("mem_fidelity='tile' models the sliced-L2 "
                             "path; direct HBM has no per-line cache events "
                             "to collapse")
        front = DirectHBM(cfg, dram, evq)
        return front, front, dram
    if tile:
        if not cfg.lrc_enabled:
            raise ValueError(
                "mem_fidelity='tile' requires the L2 request coalescer "
                "(lrc_enabled): the no-LRC ablation studies per-line "
                "request flooding and slice contention, which only exist "
                "at line-exact fidelity")
        front = TileMemory(cfg, dram, evq, scale, seed)
        return front, front, dram
    l2 = L2Cache(cfg, dram, evq, scale, seed)
    lrc = LRC(cfg, l2)
    return lrc, l2, dram
