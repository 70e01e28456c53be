"""Machine configurations for Sim-FA.

``H800`` mirrors the paper's Table 2 (the faithful GPU-mode reproduction);
``TPU_V5E`` is the hardware-adaptation target (DESIGN.md §3).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class GPUMachine:
    name: str = "H800-SXM"
    freq_ghz: float = 1.83                 # locked frequency (paper §5.3)
    num_sms: int = 132                     # 66 TPCs
    peak_tflops_fp16: float = 989.0

    # SM / TensorCore
    wgmma_issue_buffer: int = 16
    wgmma_n_cycles_divisor: float = 2.0    # FP16 m64nNk16 completes in ~N/2
    issue_width: int = 1                   # trace instructions per SM-cycle
    mufu_ops_per_cycle: int = 16           # exp throughput per SM
    fp32_ops_per_cycle: int = 128          # per WarpGroup (4x32 lanes)
    fp16_ops_per_cycle: int = 256

    # TMA engine (per SM)
    tma_lines_per_cycle: int = 2
    tma_max_inflight_lines: int = 64
    tma_launch_latency: int = 40           # common launch overhead
    tma_tmap_setup_latency: int = 130      # TensorMap descriptor path only

    # L2
    l2_bytes: int = 50 * 1024 * 1024
    l2_slices: int = 80
    l2_near_latency: int = 258
    l2_far_latency: int = 414
    l2_req_q: int = 32
    l2_resp_q: int = 128
    l2_mshr_per_slice: int = 256           # calibrated (paper Fig. 4)
    line_bytes: int = 128
    xor_hash: bool = True                  # slice = (line ^ line>>5) % N
    lrc_enabled: bool = True               # L2 Request Coalescer per SM pair
    tma_dedup: bool = True                 # dedup lines during addr generation

    # RemoteCopy partition proxy (paper §4.3): calibrated once against the
    # qualitative H800 latency curve (floor / 25-50MB window / plateau),
    # then held fixed across all experiments
    remote_copy: bool = True
    rc_max_prob: float = 0.5
    rc_occupancy_threshold: float = 0.9

    # DRAM (HBM3-5200, 80 channels, bandwidth/latency model; DESIGN.md §3)
    dram_channels: int = 80
    dram_bw_gbps: float = 3350.0           # H800 SXM aggregate
    dram_latency: int = 400                # cycles beyond L2

    occupancy_limit: int = 2               # CTAs resident per SM for FA3

    @property
    def dram_line_service_cycles(self) -> float:
        """Cycles for one 128B line per channel at aggregate bandwidth."""
        bytes_per_cycle = self.dram_bw_gbps * 1e9 / (self.freq_ghz * 1e9)
        per_chan = bytes_per_cycle / self.dram_channels
        return self.line_bytes / per_chan


@dataclass(frozen=True)
class TPUMachine:
    """TPU v5e-class single chip (the adaptation target; prompt constants)."""
    name: str = "TPU-v5e"
    freq_ghz: float = 0.94
    num_cores: int = 1                     # TensorCores per chip
    peak_tflops_bf16: float = 197.0
    hbm_gbps: float = 819.0
    ici_gbps_per_link: float = 50.0
    vmem_bytes: int = 128 * 1024 * 1024
    mxu_shape: tuple = (128, 128)
    # DMA modeling (TMA analogue): issue overhead + per-line streaming
    dma_launch_latency: int = 150          # descriptor/setup cycles
    dma_bytes_per_cycle: float = 819e9 / 0.94e9   # HBM-bound streaming
    vpu_exp_per_cycle: int = 8 * 128       # 8x128 VPU lanes, 1 exp/lane
    vpu_flops_per_cycle: int = 8 * 128 * 2

    @property
    def mxu_macs_per_cycle(self) -> float:
        return self.peak_tflops_bf16 * 1e12 / (self.freq_ghz * 1e9) / 2


H800 = GPUMachine()
TPU_V5E = TPUMachine()


def h800_variant(**kw) -> GPUMachine:
    return replace(H800, **kw)


# Measured Hopper variability envelopes (PAPERS.md microbenchmarking
# studies: arxiv 2501.12084 reports the L2 near/far and DRAM latency
# spreads around the means Table 2 pins; arxiv 2402.13499 the sustained
# clock excursions under power capping).  Kept out of ``GPUMachine`` on
# purpose: the calibrated constant-parameter model stays the paper's
# locked-frequency ideal, and ``repro_torch.faults.measured_variability`` turns
# these envelopes into a seeded :class:`~repro_torch.faults.FaultPlan` when a
# run should sample realistic spread instead.  Values are one-standard-
# deviation extra-latency envelopes in cycles (latencies) or a sustained
# derate factor (throttle).
H800_VARIABILITY = {
    "dram_jitter_std": 24.0,        # ~6% of the 400-cycle DRAM latency
    "l2_near_jitter_std": 10.0,     # near-partition lookup spread
    "l2_far_jitter_std": 22.0,      # far-partition (cross-GPC) spread
    "tma_jitter_std": 6.0,          # descriptor/launch path spread
    "completion_jitter_std": 4.0,   # async-completion delivery spread
    "throttle_factor": 1.06,        # sustained power-cap compute derate
}
