"""Engine traces of the port's own bf16 kernels as they run on an H100.

The Hopper counterpart of ``flash_grid_trace`` (``src/repro/core/tpu/tracegen.py``),
which traces the JAX package's Pallas kernel for the TPU. The traces are built
with the copied ``core/isa.py`` and ``core/kprog``'s ``CTABuilder`` (rings,
tokens, named barriers) and run on the copied ``core/engine.py``:

``fwd_trace`` walks ``csrc/flash_fwd_sm90.cu``
    One TMA producer loads the CTA's 128 query rows, then fills ``stages``
    K and V slots of 128 rows each. Two consumers of 64 rows take turns at
    the tensor cores through two named barriers (ping-pong): in its turn a
    consumer issues Q·Kᵀ of tile j and, behind it, P·V of tile j − 1, passes
    the turn, waits for Q·Kᵀ alone, frees the K slot, runs the softmax while
    P·V still runs, then waits for P·V, frees the V slot and rescales. The
    grid is in the kernel's order: the row blocks with the most tiles first,
    the query heads of one KV head adjacent. Products are ``wgmma`` steps at
    the head-dim template's width (D 112 runs 128 columns).
``decode_trace`` walks ``csrc/flash_decode_sm90.cu``
    One producer (standing for the four producer warps' 16-byte ``cp.async``
    copies, which need no tensor map: bulk loads) fills a ring of 8 slots of
    16 cache rows. Four consumer warps take the tiles in turn (warp w: tiles
    w, w + 4, ...): Sᵀ = K·Qᵀ, the softmax, Oᵀ += Vᵀ·P_hiᵀ + Vᵀ·P_loᵀ as
    ``mma.sync`` (a tile of G < 8 heads pads to the MMA's 8 columns), then the
    slot is freed. The warps merge in shared memory behind a barrier.
    The splits of a (batch, kv-head) merge inside their cluster through
    distributed shared memory; the engine has no barrier between CTAs, so the
    merge is approximated on each CTA alone: one remote round trip (an L2
    latency) plus the combine arithmetic of its share of the columns
    (``kprog.costs.combine_cycles``), with no wait for the cluster's slowest
    CTA (the splits are balanced to within one tile). The group's output
    (G x D) is stored by its first split, so DRAM sees it once.

``max_ctas`` samples the grid the way ``max_grid_rows`` does on the TPU side:
runs of adjacent CTAs (every head of one batch and row block, every cluster
of one batch) drawn over the launch order with a fixed seed. ``simulate_sm90`` runs a sample on the
matching share of the SMs (the engine scales the memory system with them), so
each SM holds the CTAs and bandwidth it would in the full launch, and a 32k
decode or a 2048 forward simulates in seconds.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, NamedTuple, Optional, Tuple

from repro_torch.configs.llama3 import AttnWorkload
from repro_torch.core import isa
from repro_torch.core.engine import CTATrace, Engine
from repro_torch.core.isa import Instr, TensorMap
from repro_torch.core.kprog.costs import combine_cycles
from repro_torch.core.kprog.ir import CTABuilder, Ring, WGProgram
from repro_torch.core.machine import GPUMachine
from repro_torch.core.sm90.analytical import fwd_tiles
from repro_torch.core.sm90.machine import (DEC, FWD, H100_SXM, ctas_per_sm,
                                           mma_sync_cycles, softmax_cycles,
                                           wgmma_cycles)

TM_Q, TM_K, TM_V, TM_O = 0, 1, 2, 3
MIN_SIM_SMS = 16    # the fewest SMs a sampled launch runs on


def _tmaps(w: AttnWorkload, q_rows: int, kv_rows: int, o_rows: int) -> Dict[int, TensorMap]:
    """The model-side layout both kernels read in place: q / o (B, L, H, D),
    K / V (B, S, Hkv, D), bf16; a box is ``rows`` rows of one head's D."""
    P, D, H = w.P, w.D, w.H_kv * w.G
    sz_q = w.B * w.L * H * D * P
    sz_kv = w.B * w.S * w.H_kv * D * P

    def tmap(mid, base, rows, heads, box_rows):
        return TensorMap(mid, base, (w.B, rows, heads * D),
                         (rows * heads * D * P, heads * D * P, P), (1, box_rows, D), P)

    return {TM_Q: tmap(TM_Q, 0, w.L, H, q_rows),
            TM_K: tmap(TM_K, sz_q, w.S, w.H_kv, kv_rows),
            TM_V: tmap(TM_V, sz_q + sz_kv, w.S, w.H_kv, kv_rows),
            TM_O: tmap(TM_O, sz_q + 2 * sz_kv, w.L, H, o_rows)}


def _mma(t: WGProgram, gid: int, steps: int, m: int, n: int, cycles: int, tag: str) -> None:
    """``steps`` products of ``cycles`` each into commit group ``gid``, committed."""
    for _ in range(steps):
        t.instrs.append(Instr(isa.WGMMA, gid=gid, m=m, n=n, k=16, cycles=cycles, tag=tag))
    t.instrs.append(Instr(isa.WGMMA_COMMIT, gid=gid))


def _wait(t: WGProgram, gid: int, n: int) -> None:
    t.instrs.append(Instr(isa.WGMMA_WAIT, gid=gid, n=n))


def _sample(total: int, max_ctas: Optional[int], run: int) -> List[int]:
    """Launch-order indices of the CTAs to simulate: all of them, or runs of
    ``run`` adjacent CTAs (``run`` divides ``total``) drawn with a fixed seed
    and kept in launch order. A run is every head of one batch (and row
    block): the heads' rows interleave in memory, so a sample of some heads
    would reach a fraction of the DRAM channels."""
    if max_ctas is None or total <= max_ctas:
        return list(range(total))
    runs = random.Random(0).sample(range(total // run), max(1, max_ctas // run))
    return [s * run + r for s in sorted(runs) for r in range(run)]


def fwd_trace(w: AttnWorkload, m: GPUMachine = H100_SXM, *, stages: int,
              max_ctas: Optional[int] = None) -> Tuple[List[CTATrace], Dict[int, TensorMap]]:
    """CTA traces of ``flash_fwd_sm90`` on ``w`` (ring depth ``stages``), in launch
    order, sampled to ``max_ctas``."""
    D, H = w.D, w.H_kv * w.G
    dp = FWD.template(D)
    rows = FWD.CONSUMERS * FWD.BM
    qk = wgmma_cycles(FWD.BM, FWD.BN, 16, m)          # one k16 step of Q·Kᵀ
    pv = wgmma_cycles(FWD.BM, dp, 16, m)              # one k16 step of P·V
    n_qk, n_pv = dp // 16, FWD.BN // 16
    sm = softmax_cycles(FWD.BM, FWD.BN, m)            # mask, max, exp2, sums, pack
    rescale = softmax_cycles(FWD.BM, 0, m, d=dp)      # acc *= corr
    norm = math.ceil(FWD.BM * dp / m.fp32_ops_per_cycle)
    tiles = fwd_tiles(w)
    n_mblk = len(tiles)
    heads = w.B * H
    ctas = []
    for item in _sample(n_mblk * heads, max_ctas, H):
        h, b, r = item % H, item // H % w.B, item // heads
        m0, hk, n_tiles = (n_mblk - 1 - r) * rows, h // w.G, tiles[r]
        cb = CTABuilder(rings=(Ring("K", stages), Ring("V", stages)),
                        n_consumers=FWD.CONSUMERS, name=f"b{b}h{h}m{m0}")
        p = cb.wg("producer")
        p.load(TM_Q, (b, m0, h * D), token="q_ready", tag="Q")
        for j in range(n_tiles):
            p.acquire("K", j)
            p.load(TM_K, (b, j * FWD.BN, hk * D), ring="K", slot=j, tag=f"K{j}")
            p.acquire("V", j)
            p.load(TM_V, (b, j * FWD.BN, hk * D), ring="V", slot=j, tag=f"V{j}")
        for c in range(FWD.CONSUMERS):
            t = cb.wg(f"consumer{c}")
            mine, theirs = f"turn{c}", f"turn{1 - c}"
            if c == 1:
                t.arrive("turn0")                     # consumer 0 starts
            t.wait_token("q_ready")
            for j in range(n_tiles):
                gid = 2 * j
                t.wait_tile("K", j)
                t.await_arrivals(mine, j + 1)
                _mma(t, gid, n_qk, FWD.BM, FWD.BN, qk, f"QK{j}")
                if j:
                    t.wait_tile("V", j - 1)
                    _mma(t, gid - 1, n_pv, FWD.BM, dp, pv, f"PV{j - 1}")
                if c == 0 or j + 1 < n_tiles:
                    t.arrive(theirs)
                _wait(t, gid, 1 if j else 0)          # S_j done; P·V may still run
                t.release("K", j)
                t.bubbles(sm)
                if j:
                    _wait(t, gid - 1, 0)
                    t.release("V", j - 1)
                t.bubbles(rescale)
            last = 2 * n_tiles - 1
            t.wait_tile("V", n_tiles - 1)
            _mma(t, last, n_pv, FWD.BM, dp, pv, f"PV{n_tiles - 1}")
            _wait(t, last, 0)
            t.release("V", n_tiles - 1)
            t.bubbles(norm)
            if m0 + c * FWD.BM < w.L:                 # TMA clips rows >= L
                t.store(TM_O, (b, m0 + c * FWD.BM, h * D), tag="O")
        ctas.append(cb.finish())
    return ctas, _tmaps(w, rows, FWD.BN, FWD.BM)


def decode_trace(w: AttnWorkload, m: GPUMachine = H100_SXM, *, n_split: int,
                 max_ctas: Optional[int] = None) -> Tuple[List[CTATrace], Dict[int, TensorMap]]:
    """CTA traces of ``flash_decode_sm90`` for one token (``w.L == 1``) against
    ``w.S`` cached rows, in ``n_split`` splits, in launch order, sampled to
    ``max_ctas``."""
    G, D = w.G, w.D
    dp, nb = DEC.template(D), DEC.head_blocks(G)
    tiles = math.ceil(w.S / DEC.TN)
    qk = mma_sync_cycles(DEC.TN, 8 * nb, dp)
    pv = 2 * mma_sync_cycles(dp, 8 * nb, DEC.TN)          # P_hi and P_lo
    sm = DEC.NW * softmax_cycles(DEC.TN, 8 * nb, m, d=dp)  # one warp: a quarter of the lanes
    warp_merge = math.ceil(DEC.NW * G * D / m.fp32_ops_per_cycle)
    cluster_merge = (combine_cycles(m, G, math.ceil(D / n_split), n_split) + m.l2_near_latency
                     if n_split > 1 else 0)
    ctas = []
    for item in _sample(w.B * w.H_kv * n_split, max_ctas, w.H_kv * n_split):
        split, hk, b = item % n_split, item // n_split % w.H_kv, item // (n_split * w.H_kv)
        t0 = split * tiles // n_split
        n_tiles = (split + 1) * tiles // n_split - t0
        cb = CTABuilder(rings=(Ring("K", DEC.RING), Ring("V", DEC.RING)), n_consumers=1,
                        name=f"b{b}h{hk}s{split}")
        p = cb.wg("producer")
        p.load(TM_Q, (b, 0, hk * G * D), token="q_ready", tag="Q", bulk=True)
        for j in range(n_tiles):
            row = (t0 + j) * DEC.TN
            p.acquire("K", j)
            p.load(TM_K, (b, row, hk * D), ring="K", slot=j, tag=f"K{j}", bulk=True)
            p.acquire("V", j)
            p.load(TM_V, (b, row, hk * D), ring="V", slot=j, tag=f"V{j}", bulk=True)
        for wi in range(DEC.NW):
            t = cb.wg(f"consumer{wi}")
            t.wait_token("q_ready")
            for j in range(wi, n_tiles, DEC.NW):
                t.wait_tile("K", j)
                t.wait_tile("V", j)
                _mma(t, 2 * j, 1, DEC.TN, 8 * nb, qk, f"QK{j}")
                _wait(t, 2 * j, 0)
                t.bubbles(sm)
                _mma(t, 2 * j + 1, 1, dp, 8 * nb, pv, f"PV{j}")
                _wait(t, 2 * j + 1, 0)
                t.release("K", j)
                t.release("V", j)
            t.arrive("warps")
            t.await_arrivals("warps", DEC.NW)
            t.bubbles(warp_merge // DEC.NW + cluster_merge)
            if wi == 0 and split == 0:
                t.store(TM_O, (b, 0, hk * G * D), tag="O")
        ctas.append(cb.finish())
    return ctas, _decode_tmaps(w)


def _decode_tmaps(w: AttnWorkload) -> Dict[int, TensorMap]:
    """q / o (B, 1, H·D), a group's G heads a box; K / V (B, S, Hkv·D), 16 rows."""
    maps = _tmaps(w, 1, DEC.TN, 1)
    P, D, GD = w.P, w.D, w.G * w.D
    H = w.H_kv * w.G
    for mid in (TM_Q, TM_O):
        base = maps[mid].base
        maps[mid] = TensorMap(mid, base, (w.B, 1, H * D), (H * D * P, H * D * P, P),
                              (1, 1, GD), P)
    return maps


class SM90Sim(NamedTuple):
    us: float
    cycles: int
    ctas: int                   # CTAs of the full launch
    ctas_simulated: int
    sms_simulated: int
    deadlocked: bool


def simulate_sm90(w: AttnWorkload, m: GPUMachine = H100_SXM, *, kernel: str,
                  stages: Optional[int] = None, n_split: Optional[int] = None,
                  max_ctas: Optional[int] = None) -> SM90Sim:
    """Cycle-simulate one launch of ``kernel`` (``stages`` for the forward,
    ``n_split`` for the decode, both required). A sample of ``max_ctas`` runs
    on the share of the SMs that the full launch would give it, so that each
    SM holds as many CTAs, and as much of the memory system, as in the full
    launch; the sampled run's time stands for the launch's. Memory is
    simulated a tile at a time (the engine's ``mem_fidelity="tile"``)."""
    if kernel == "flash_fwd":
        total = len(fwd_tiles(w)) * w.B * w.H_kv * w.G
        per_sm = ctas_per_sm(kernel, w.D, stages=stages)
    elif kernel == "flash_decode":
        total = w.B * w.H_kv * n_split
        per_sm = ctas_per_sm(kernel, w.D, G=w.G)
    else:
        raise ValueError(f"kernel must be 'flash_fwd' or 'flash_decode', got {kernel!r}")
    if max_ctas is not None:
        # a sample on a handful of SMs shrinks the scaled L2 past what the
        # launch's working set needs (whisper's encoder ran 10x slow on 9)
        max_ctas = max(max_ctas, math.ceil(total * MIN_SIM_SMS / m.num_sms))
    if kernel == "flash_fwd":
        ctas, tmaps = fwd_trace(w, m, stages=stages, max_ctas=max_ctas)
    else:
        ctas, tmaps = decode_trace(w, m, n_split=n_split, max_ctas=max_ctas)
    n_sms = max(1, round(m.num_sms * len(ctas) / total))
    # the card spreads a launch that fits in fewer than its slots over all SMs
    # (the engine fills each SM to its limit before the next)
    per_sm = min(per_sm, math.ceil(total / m.num_sms))
    eng = Engine(dataclasses.replace(m, occupancy_limit=per_sm), n_sms=n_sms,
                 mem_fidelity="tile")
    for tm in tmaps.values():
        eng.define_tmap(tm)
    eng.launch(ctas)
    st = eng.run()
    return SM90Sim(us=st["time_us"], cycles=st["cycles"], ctas=total,
                   ctas_simulated=len(ctas), sms_simulated=n_sms,
                   deadlocked=eng.deadlocked)
