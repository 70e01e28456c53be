"""Roofline analysis over the dry-run's records, the counterpart of
``src/repro/launch/roofline.py``, with an NVIDIA H100's constants.

For every (arch x shape x mesh) record in ``results/dryrun_torch.json``:

    compute    = counted FLOPs per device  / PEAK_FLOPS
    memory     = counted bytes per device  / HBM_BW
    collective = collective wire bytes per device / LINK_BW

The record's numbers are one device's already. The dominant term is the
bottleneck; ``MODEL_FLOPS`` (6*N*D train, 2*N*D prefill, 2*N_active*B decode)
over the counted FLOPs of all devices measures how much of the computed work is
useful (remat recomputes show up here); ``roofline_fraction`` = ideal compute
time of the useful FLOPs / dominant term. The arithmetic is the reference's
line for line; ``analyze_record`` takes the three constants as keyword
arguments. The key ``hlo_flops_total`` keeps the reference's name: here it is
the counter's FLOPs of all devices (the port has no HLO).

The times these give are predictions for an H100 SXM5 from its data sheet,
not measurements; the bytes are an eager step's (``utils/cost.py``: no
fusion), so the memory term is an upper bound.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--json results/dryrun_torch.json]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Optional

from repro_torch.configs import registry

# NVIDIA H100 SXM5 (NVIDIA's data sheet; dense, at the 700 W limit: the card
# the port runs on reads "NVIDIA H100 80GB HBM3, 700.00 W" in
# nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
PEAK_FLOPS = 989e12          # bf16 / GPU, dense tensor-core rate
HBM_BW = 3.35e12             # bytes/s / GPU, HBM3
# the slowest link an axis of 16 GPUs crosses: on 8-GPU NVLink nodes every
# such axis spans two nodes, so one NDR InfiniBand port a GPU, 400 Gb/s
# (NVLink 4 inside a node gives 450 GB/s a direction)
LINK_BW = 50e9               # bytes/s / GPU


def model_flops_total(arch: str, kind: str, tokens: int) -> float:
    """Useful model FLOPs for the whole step (all devices). The parameter count
    is the copied configs' ``active_param_count``, the reference's formula
    (which leaves out rwkv's ``tmix.wg`` and ``cmix.wr``, ROADMAP A5a)."""
    cfg = registry.get(arch)
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * tokens
    # forward-only: 2*N per token (prefill tokens = B*S; decode tokens = B)
    return 2.0 * n_active * tokens


def analyze_record(key: str, rec: dict, *, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    arch, shape, mesh = rec["arch"], rec["shape"], rec["mesh"]
    n_dev = rec["devices"]
    t_compute = rec["flops_per_device"] / peak_flops
    t_memory = rec["bytes_per_device"] / hbm_bw
    t_coll = rec["collective_bytes_per_device"] / link_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    dominant = terms[bottleneck]

    m_flops = model_flops_total(arch, rec["kind"], rec["tokens"])
    hlo_total = rec["flops_per_device"] * n_dev
    useful_ratio = m_flops / hlo_total if hlo_total else 0.0
    t_useful = (m_flops / n_dev) / peak_flops
    frac = t_useful / dominant if dominant else 0.0

    suggest = {
        "compute": ("reduce non-useful FLOPs (remat policy, fused loss, "
                    "bf16 compute) — compute-bound is the good case"),
        "memory": ("raise arithmetic intensity: larger fused blocks, "
                   "bf16 activations/optimizer, avoid HBM round-trips "
                   "between layers"),
        "collective": ("reshard to cut all-gather/reduce-scatter volume: "
                       "different TP/FSDP split, overlap collectives with "
                       "compute, gradient-accumulation deferred psum"),
    }[bottleneck]
    return {
        "key": key, "arch": arch, "shape": shape, "mesh": mesh,
        "devices": n_dev,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        "model_flops": m_flops,
        "hlo_flops_total": hlo_total,
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": frac,
        "peak_bytes": rec["mem"]["peak_bytes"],
        "suggestion": suggest,
    }


def analyze_all(dryrun_json: Path) -> Dict[str, dict]:
    data = json.loads(Path(dryrun_json).read_text())
    out = {}
    for key, rec in data.items():
        r = analyze_record(key, rec)
        if r:
            out[key] = r
    return out


def to_markdown(rows: Dict[str, dict], mesh: str = "single_pod_16x16") -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bound | "
           "useful/counted | roofline frac |")
    sep = "|---|---|---|---|---|---|---|---|"
    lines = [hdr, sep]
    for r in sorted(rows.values(), key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"**{r['bottleneck']}** | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/dryrun_torch.json")
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--mesh", default="single_pod_16x16")
    args = ap.parse_args(argv)
    rows = analyze_all(Path(args.json))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    print(to_markdown(rows, args.mesh))
    worst = sorted((r for r in rows.values() if r["mesh"] == args.mesh),
                   key=lambda r: r["roofline_fraction"])
    print("\nworst roofline fractions:")
    for r in worst[:5]:
        print(f"  {r['arch']}|{r['shape']}: {r['roofline_fraction']:.3f} "
              f"({r['bottleneck']}-bound) -> {r['suggestion']}")
    coll = sorted((r for r in rows.values() if r["mesh"] == args.mesh),
                  key=lambda r: -(r["t_collective_s"]
                                  / max(max(r["t_compute_s"], r["t_memory_s"]), 1e-12)))
    print("\nmost collective-bound:")
    for r in coll[:5]:
        ratio = r["t_collective_s"] / max(max(r["t_compute_s"], r["t_memory_s"]), 1e-12)
        print(f"  {r['arch']}|{r['shape']}: coll/max(other)={ratio:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
