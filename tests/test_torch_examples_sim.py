"""The port's twins of the two simulator examples,
``examples/torch_analyze_pipeline.py`` and ``examples/torch_simulate_dse.py``,
run on the CPU in this process beside their references
(``examples/analyze_pipeline.py``, ``examples/simulate_dse.py``): the same
command line prints the same numbers, and the DSE twin's study B, which picks
the port's own bf16 forward tiling on the H100 SXM where the reference picks
Pallas blocks on TPU v5e, picks settings the kernel is built with and whose
shared memory fits a block."""
import importlib.util
import sys
from pathlib import Path

import pytest

from repro_torch.configs import registry
from repro_torch.core.sm90.machine import FWD, SMEM_PER_BLOCK, smem_bytes

ROOT = Path(__file__).resolve().parent.parent
ANALYZE_ARGS = ["--model", "8B", "--seqlen", "256", "--knob", "tma_bw=0.5,1,2"]
DSE_CASES = {"qwen2.5-3b": 32768, "command-r-plus-104b": 32768, "dbrx-132b": 4096,
             "olmo-1b": 4096}


def _example(name):
    """``examples/<name>.py`` as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(capsys, fn, *args):
    capsys.readouterr()
    out = fn(*args)
    return capsys.readouterr().out, out


def test_analyze_pipeline_twin_prints_the_references_numbers(capsys, monkeypatch):
    """``--model 8B --seqlen 256 --knob tma_bw=0.5,1,2``: the simulated
    cycles, the stall table, the critical path and the what-if table, line
    for line."""
    monkeypatch.setattr(sys, "argv", ["analyze_pipeline.py"] + ANALYZE_ARGS)
    want, _ = _printed(capsys, _example("analyze_pipeline").main)
    got, _ = _printed(capsys, _example("torch_analyze_pipeline").main, ANALYZE_ARGS)
    assert "cycles" in want and "speedup" in want
    assert got == want


@pytest.mark.parametrize("study", ["study_a", "study_c"])
def test_simulate_dse_twin_prints_the_references_studies(capsys, study):
    """Studies A (DRAM-traffic regimes against GenZ on the H800) and C (the
    what-if hardware sweep) on the port's copies of ``analytical`` and
    ``genz_baseline``: the reference's lines."""
    want, _ = _printed(capsys, getattr(_example("simulate_dse"), study))
    got, _ = _printed(capsys, getattr(_example("torch_simulate_dse"), study))
    assert got == want and want.count("\n") > 5


def test_simulate_dse_twin_picks_legal_h100_plans(capsys):
    """Study B over the reference's four attention shapes: for each a ring
    depth the bf16 forward is built with at the shape's head dim, whose
    shared memory fits a block (``core/sm90/machine.py``), and a positive
    prediction, all printed; the whole script runs."""
    text, out = _printed(capsys, _example("torch_simulate_dse").main, [])
    picks = out["study_b"]
    assert set(picks) == set(DSE_CASES)
    for arch, plan in picks.items():
        D = registry.get(arch).head_dim
        assert plan.kernel == "flash_fwd" and plan.stages in FWD.built(D)
        assert plan.smem_bytes == smem_bytes("flash_fwd", D, plan.stages) <= SMEM_PER_BLOCK
        assert plan.predicted_us > 0
        assert f"{plan.predicted_us:>9.1f}" in text and arch in text
    for study in ("A. DRAM traffic", "B. SimFA-H100", "C. What-if"):
        assert study in text
