"""Sim-FA instruction set (paper Table 3).

Instructions are lightweight tuples (opcode + operands) produced by the
trace generators and consumed by the engine. ``sid`` indexes mbarriers /
ring-buffer stages, ``gid`` async commit groups, ``bid`` named barriers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# opcodes
DEF_TMAP = "DEF_TMAP"
TMA_TENSOR = "TMA_TENSOR"          # async HBM->SMEM tile load, signals sid
MB_WAIT = "MB_WAIT"                # mbarrier.try_wait on sid
ACQUIRE_STAGE = "ACQUIRE_STAGE"    # pipeline.producer_acquire
RELEASE_STAGE = "RELEASE_STAGE"    # pipeline.consumer_release
TMA_STORE = "TMA_STORE"            # async SMEM->HBM store in group gid
TMA_COMMIT = "TMA_COMMIT"
TMA_WAIT = "TMA_WAIT"              # block until <=N groups outstanding
WGMMA = "WGMMA"                    # async MMA MxNxK into group gid
WGMMA_COMMIT = "WGMMA_COMMIT"
WGMMA_WAIT = "WGMMA_WAIT"
BAR_ARRIVE = "BAR_ARRIVE"          # named barrier non-blocking signal
BAR_WAIT = "BAR_WAIT"              # block until >=k arrives
BUBBLES = "BUBBLES"                # CUDA-core work (softmax etc.)

# Well-known operand values shared by the trace generators and engine-side
# tooling.  Point-to-point tokens (e.g. "Q tile ready") use mbarrier sids
# allocated upward from Q_READY_SID, far above the ring-buffer stage sids
# (allocated upward from 0), so the two namespaces cannot collide; epilogue
# TMA store groups use EPILOGUE_GID, far above any WGMMA commit-group id.
Q_READY_SID = 98                   # first point-to-point token sid
EPILOGUE_GID = 99                  # epilogue TMA store commit group


@dataclass(frozen=True)
class TensorMap:
    """cuTensorMapEncodeTiled analogue: enough metadata for hardware address
    generation of a box (tile) anywhere in a strided tensor."""
    map_id: int
    base: int                      # byte address
    dims: Tuple[int, ...]          # logical tensor dims (row-major outer..inner)
    strides: Tuple[int, ...]       # byte strides per dim
    box: Tuple[int, ...]           # tile shape in elements
    esz: int                       # element size in bytes

    def tile_lines(self, origin: Tuple[int, ...], line_bytes: int,
                   dedup: bool = True):
        """Generate the cache-line addresses touched by the tile at
        ``origin``. With dedup=False, address generation is per *element*
        ("If we generate requests for each element, many duplicate requests
        will be generated" — §5.4): every element emits a request for its
        containing line (ablation: 'No line deduplication', paper Table 5)."""
        # innermost dim assumed contiguous (stride == esz)
        inner = self.box[-1] * self.esz
        lines: list = []
        # fold the outer dims into a flat row-major list of row base
        # addresses (outer index varies slowest — same depth-first order
        # as the recursive formulation this replaces)
        addrs = [self.base + origin[-1] * self.esz]
        for dim in range(len(self.box) - 1):
            o = origin[dim]
            s = self.strides[dim]
            addrs = [a + (o + i) * s
                     for a in addrs for i in range(self.box[dim])]
        if dedup:
            seen: set = set()
            add = seen.add
            ap = lines.append
            if inner % line_bytes == 0 and self.base % line_bytes == 0:
                # aligned rows: each row is exactly inner//line_bytes whole
                # lines starting at the row address (no per-line rounding)
                nl = inner // line_bytes
                for addr in addrs:
                    if addr % line_bytes:
                        a = addr - addr % line_bytes
                        end = addr + inner
                        while a < end:
                            if a not in seen:
                                add(a)
                                ap(a)
                            a += line_bytes
                    else:
                        for k in range(nl):
                            a = addr + k * line_bytes
                            if a not in seen:
                                add(a)
                                ap(a)
            else:
                for addr in addrs:
                    end = addr + inner
                    a = addr - addr % line_bytes
                    while a < end:
                        if a not in seen:
                            add(a)
                            ap(a)
                        a += line_bytes
        else:
            esz = self.esz
            ap = lines.append
            for addr in addrs:
                for e in range(self.box[-1]):
                    a = addr + e * esz
                    ap(a - a % line_bytes)
        return lines


@dataclass(frozen=True)
class Instr:
    op: str
    # generic operand fields (interpretation depends on op)
    sid: int = -1
    gid: int = -1
    bid: int = -1
    n: int = 0                      # WGMMA_WAIT/TMA_WAIT N; BAR_WAIT k
    m: int = 0                      # WGMMA M
    k: int = 0                      # WGMMA K
    cycles: int = 0                 # BUBBLES
    map_id: int = -1                # TMA ops
    origin: Tuple[int, ...] = ()    # TMA tile origin
    bulk: bool = False              # non-tensor bulk copy: skips the
                                    # descriptor-cache/TensorMap setup (Fig. 2)
    tag: str = ""                   # debug label (e.g. "K", "V", "QK", "PV")
