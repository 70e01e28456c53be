"""H100 SXM model of the port's own two bf16 kernels for the Sim-FA engine.

The Hopper counterpart of ``src/repro/core/tpu/machine.py``: where that module
parameterises one TPU core for the engine and prices the MXU and VPU, this one
holds

  * ``H100_SXM``: the paper's calibrated H800 preset (``core/machine.py``) with
    the H100 SXM's name and the SM clock the card ran at while it was timed.
    The clock is passed in (``h100_sxm(freq_ghz)``): an H100 boosts, and its
    clock cannot be pinned, so the caller reads it (``nvidia-smi``) and hands
    it over. The other fields are the H800's: 132 SMs, 50 MB of L2, 3.35 TB/s
    of HBM3 and 989 TFLOP/s of dense bf16 are the H100 SXM's as well (each is
    held against the card's own reading in ``PERF.md``);
  * the kernels' own constants, as data, mirrored from
    ``kernels/csrc/flash_fwd_sm90.cu`` (``FWD``) and
    ``kernels/csrc/flash_decode_sm90.cu`` (``DEC``); a drift test reads them
    back out of the sources;
  * what a kernel may hold on an SM (``smem_bytes``, ``ctas_per_sm``), the
    counterpart of the TPU autotuner's VMEM check;
  * the cost of the kernels' products and softmax as the kernels run them
    (``wgmma_cycles``, ``mma_sync_cycles``, ``softmax_cycles``), the
    counterparts of ``mxu_cycles`` / ``vpu_softmax_cycles``. Padding is what
    the kernels really do: head_dim 112 runs the forward's 128-column
    template, and a decode tile of G query heads fills G of the MMA's 8
    columns.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.kprog.costs import softmax_bubble_cycles
from repro_torch.core.machine import GPUMachine, h800_variant

# per SM and per block (NVIDIA's Hopper tuning guide; held against
# torch.cuda.get_device_properties on the card by chip_smoke.py's plan phase)
SMEM_PER_SM = 233472             # 228 KB of shared memory an SM
SMEM_PER_BLOCK = 232448          # 227 KB of dynamic shared memory a block may opt into
SMEM_RESERVED_PER_BLOCK = 1024   # kept by the system for every resident block
REGS_PER_SM = 65536
THREADS_PER_SM = 2048
MMA_SYNC_CYCLES = 2              # SM-cycles of one mma.sync.m16n8k16: half the wgmma rate


def h100_sxm(freq_ghz: float = 1.98) -> GPUMachine:
    """The H100 SXM at SM clock ``freq_ghz`` (default: the 1980 MHz the card
    read at every kernel timing so far)."""
    return h800_variant(name="H100-SXM", freq_ghz=freq_ghz)


H100_SXM = h100_sxm()


@dataclass(frozen=True)
class FwdKernel:
    """``csrc/flash_fwd_sm90.cu``: one producer warpgroup and two consumer
    warpgroups of BM query rows over K/V tiles of BN rows, in a ring of
    ``stages`` slots. ``BUILT`` maps each head-dim template to the ring depths
    it is compiled with; ``DEFAULT`` is the depth a call takes by default."""
    BM: int = 64
    BN: int = 128
    CONSUMERS: int = 2
    SW: int = 64                     # bf16 columns of one 128-byte swizzle row
    PRODUCER_REGS: int = 24
    CONSUMER_REGS: int = 240
    BUILT: tuple = ((128, (2, 3)), (64, (2, 3, 4)))
    DEFAULT: tuple = ((128, 2), (64, 4))

    @property
    def threads(self) -> int:
        return (self.CONSUMERS + 1) * 128

    def template(self, D: int) -> int:
        """The head-dim template that runs head_dim ``D`` (D 112 runs 128)."""
        return 128 if D > 64 else 64

    def built(self, D: int) -> tuple:
        return dict(self.BUILT)[self.template(D)]

    def default_stages(self, D: int) -> int:
        return dict(self.DEFAULT)[self.template(D)]


@dataclass(frozen=True)
class DecKernel:
    """``csrc/flash_decode_sm90.cu``: NW consumer warps and NP producer warps a
    CTA, tiles of TN cache rows in a ring of RING slots, at most MAX_SPLIT
    CTAs (one cluster) a (batch, kv-head). Up to 8 query heads a KV head the
    kernel is bounded to two CTAs an SM (128 registers a thread); with more,
    one."""
    TN: int = 16
    NW: int = 4
    NP: int = 4
    RING: int = 8
    MAX_SPLIT: int = 16

    @property
    def threads(self) -> int:
        return (self.NW + self.NP) * 32

    def template(self, D: int) -> int:
        return 128 if D > 64 else 64

    def head_blocks(self, G: int) -> int:
        """Blocks of 8 query heads in the MMA's columns (NB)."""
        return 1 if G <= 8 else 2

    def regs(self, G: int) -> int:
        return 128 if self.head_blocks(G) == 1 else 255


FWD = FwdKernel()
DEC = DecKernel()


def smem_bytes(kernel: str, D: int, stages: int = 0) -> int:
    """Dynamic shared memory of one CTA: ``Layout<DP, STAGES>::ALLOC`` of the
    forward (``stages`` its ring depth) or ``Layout<DP>::ALLOC`` of the decode."""
    if kernel == "flash_fwd":
        kb = FWD.template(D) // FWD.SW
        q_tile = kb * FWD.BM * FWD.SW * 2
        kv_tile = kb * FWD.BN * FWD.SW * 2
        bar_off = FWD.CONSUMERS * q_tile + 2 * stages * kv_tile
        return bar_off + (1 + 4 * stages) * 8 + 1024
    if kernel == "flash_decode":
        dp = DEC.template(D)
        row = dp * 2 + 16
        bar_off = DEC.RING * 2 * DEC.TN * row
        inbox = bar_off + 2 * DEC.RING * 8 + 2 * DEC.NW * 16 * 4
        inbox_floats = 2 * DEC.MAX_SPLIT * 16 + 16 * (dp + 4 * (DEC.MAX_SPLIT - 1))
        return inbox + inbox_floats * 4
    raise ValueError(f"kernel must be 'flash_fwd' or 'flash_decode', got {kernel!r}")


def ctas_per_sm(kernel: str, D: int, *, stages: int = 0, G: int = 1) -> int:
    """CTAs of ``kernel`` resident on one SM: the least of what shared memory,
    registers and threads allow. The forward's 384 threads keep 168 registers
    each at launch (64512 of 65536), so it is one CTA an SM whatever its ring."""
    if kernel == "flash_fwd":
        threads, regs = FWD.threads, REGS_PER_SM // FWD.threads // 8 * 8
    else:
        threads, regs = DEC.threads, DEC.regs(G)
    by_smem = SMEM_PER_SM // (smem_bytes(kernel, D, stages) + SMEM_RESERVED_PER_BLOCK)
    return min(by_smem, REGS_PER_SM // (threads * regs), THREADS_PER_SM // threads)


def wgmma_cycles(m: int, n: int, k: int, gpu: GPUMachine = H100_SXM) -> int:
    """SM-cycles of an (m x k)(k x n) bf16 product as ``wgmma.m64nNk16`` steps:
    m pads to 64 rows, n to a multiple of 8, k to 16; a step takes N / 2 cycles
    (the engine's own rate, 4096 operations an SM-cycle)."""
    n_pad = math.ceil(n / 8) * 8
    step = max(1, int(round(n_pad / gpu.wgmma_n_cycles_divisor)))
    return math.ceil(m / 64) * math.ceil(k / 16) * step


def mma_sync_cycles(m: int, n: int, k: int) -> int:
    """SM-cycles of an (m x k)(k x n) bf16 product as ``mma.sync.m16n8k16``:
    m pads to 16, n to 8 (a decode tile of G < 8 heads leaves 8 - G columns
    empty), k to 16; each at ``MMA_SYNC_CYCLES``."""
    return math.ceil(m / 16) * math.ceil(n / 8) * math.ceil(k / 16) * MMA_SYNC_CYCLES


def softmax_cycles(rows: int, cols: int, gpu: GPUMachine = H100_SXM, d: int = 0) -> int:
    """CUDA-core cycles of one warpgroup's online softmax of a (rows x cols)
    fp32 score tile: row max, exp2, row sum and the bf16 pack (the paper's
    §5.2 arithmetic, ``kprog.costs``), plus the rescale of a (rows x d)
    accumulator."""
    return softmax_bubble_cycles(gpu, rows, cols, d)
