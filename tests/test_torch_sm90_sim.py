"""SimFA-H100 (``repro_torch.core.sm90``): the models of the port's own bf16
kernels, the kernels' tiling parameters, and the models' picks.

The counterparts of ``tests/test_tpu_sim.py`` (traces that run, ring depth,
product padding, regimes, legal plans, the simulated short-list, softmax
scaling); the FLOP count held to the JAX package's two analytical models; the
decode's bytes; the split arithmetic of ``flash_decode_plain(n_split=k)``
against the JAX package's reference decode; the wrappers' argument checks; the
model's constants read back out of the CUDA sources; the launchers' SimFA-H100
lines; and the import rule.
"""
import dataclasses
import pathlib
import re
import signal
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")  # optional dev dep: degrade, don't die
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import llama3 as jllama3  # noqa: E402
from repro.core import analytical as janalytical  # noqa: E402
from repro.core.machine import H800 as JH800  # noqa: E402
from repro.core.tpu.analytical import analyze_tpu  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.llama3 import AttnWorkload  # noqa: E402
from repro_torch.core.sm90 import machine as sm90  # noqa: E402
from repro_torch.core.sm90.analytical import analyze_sm90  # noqa: E402
from repro_torch.core.sm90.autotune import (autotune_decode, autotune_flash,  # noqa: E402
                                            decode_candidates, flash_candidates)
from repro_torch.core.sm90.tracegen import decode_trace, fwd_trace, simulate_sm90  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

CSRC = pathlib.Path(tfa.__file__).parent / "csrc"


def _fwd(L=512, S=None, H_kv=2, G=2, D=128, B=1, causal=True):
    return AttnWorkload(name="t", B=B, L=L, S=S or L, H_kv=H_kv, G=G, D=D, causal=causal)


def _dec(S=520, H_kv=2, G=8, D=128, B=2):
    return AttnWorkload(name="d", B=B, L=1, S=S, H_kv=H_kv, G=G, D=D)


# ---------------------------------------------------------------------------
# counterparts of tests/test_tpu_sim.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,w,setting", [
    ("flash_fwd", _fwd(), dict(stages=2)),
    ("flash_fwd", _fwd(L=64, S=300, G=1, D=64, causal=False), dict(stages=4)),
    ("flash_decode", _dec(), dict(n_split=4)),
    ("flash_decode", _dec(S=70, G=1, D=112), dict(n_split=1)),
])
def test_trace_runs_without_deadlock(kernel, w, setting):
    sim = simulate_sm90(w, kernel=kernel, **setting)
    assert not sim.deadlocked
    assert sim.cycles > 0 and sim.us > 0
    assert sim.ctas_simulated == sim.ctas


def test_traces_follow_the_kernels_grids():
    """The forward: B * H * ceil(L / 128) CTAs, the heaviest row block first,
    two consumers and a producer; the decode: B * Hkv * n_split CTAs of four
    consumer warps and a producer, each over its balanced run of 16-row tiles."""
    w = _fwd(L=300, H_kv=2, G=2)
    ctas, _ = fwd_trace(w, stages=3)
    assert len(ctas) == 1 * 4 * 3
    assert ctas[0].roles == ["producer", "consumer0", "consumer1"]
    loads = [sum(i.op == "TMA_TENSOR" for i in c.wgs[0]) for c in ctas]
    assert loads[0] == 1 + 2 * 3 and loads[-1] == 1 + 2 * 1      # Q + K/V tiles
    d = _dec(S=100, B=1, H_kv=2)
    ctas, _ = decode_trace(d, n_split=3)
    assert len(ctas) == 2 * 3 and ctas[0].roles[1:] == [f"consumer{i}" for i in range(4)]
    tiles = [sum(i.op == "TMA_TENSOR" for i in c.wgs[0]) // 2 for c in ctas[:3]]
    assert tiles == [2, 2, 3]                                   # 7 tiles in balanced runs


def test_sampled_one_wave_launch_reads_as_the_full_one():
    """``max_ctas`` runs whole batches of CTAs on their share of the SMs: for a
    launch that fits one wave the sample's time stands for the launch's."""
    w = _dec(S=4096, B=4)
    full = simulate_sm90(w, kernel="flash_decode", n_split=16)
    part = simulate_sm90(w, kernel="flash_decode", n_split=16, max_ctas=32)
    assert part.ctas == full.ctas == 128
    assert part.ctas_simulated == 32 and part.sms_simulated == 33
    assert part.us == pytest.approx(full.us, rel=0.05)


@pytest.mark.parametrize("D,depths", [(64, (2, 3, 4)), (128, (2, 3))])
def test_more_stages_never_slower(D, depths):
    """A deeper K/V ring never costs more than 2 % in the cycle model."""
    w = _fwd(L=1024, H_kv=2, G=2, D=D)
    us = [simulate_sm90(w, kernel="flash_fwd", stages=s).us for s in depths]
    for shallow, deep in zip(us, us[1:]):
        assert deep <= shallow * 1.02


def test_wgmma_padding_and_monotone_cycles():
    """D 112 runs the 128-column template: it costs what D 128 costs (14 % more
    MMA work than it needs); a decode tile of 1 head fills 1 of the MMA's 8
    columns and costs what 8 heads cost; cycles grow with each dim."""
    assert sm90.FWD.template(112) == sm90.FWD.template(128) == 128
    r112 = analyze_sm90(_fwd(D=112), kernel="flash_fwd")
    r128 = analyze_sm90(_fwd(D=128), kernel="flash_fwd")
    assert r112.t_compute == r128.t_compute
    assert r112.flops == pytest.approx(r128.flops * 112 / 128)
    assert sm90.mma_sync_cycles(16, 1, 128) == sm90.mma_sync_cycles(16, 8, 128)
    d1 = analyze_sm90(_dec(G=1), kernel="flash_decode", n_split=4)
    d8 = analyze_sm90(_dec(G=8), kernel="flash_decode", n_split=4)
    assert d1.t_compute == d8.t_compute
    base = sm90.wgmma_cycles(64, 128, 128)
    assert sm90.wgmma_cycles(128, 128, 128) == 2 * base
    assert sm90.wgmma_cycles(64, 256, 128) == 2 * base
    assert sm90.wgmma_cycles(64, 128, 256) == 2 * base
    assert sm90.wgmma_cycles(32, 128, 128) == base                # m pads to 64


def test_analyze_sm90_regimes():
    long_dec = analyze_sm90(_dec(S=32768, B=4), kernel="flash_decode")
    assert long_dec.bottleneck == "dram"
    assert long_dec.n_split == tfd.num_splits_sm90(32768, 8)
    fwd = analyze_sm90(_fwd(L=8192, H_kv=8, G=4), kernel="flash_fwd")
    assert fwd.bottleneck in ("compute", "l2", "softmax", "latency")
    assert fwd.t_compute > fwd.t_dram and fwd.flops > 0
    # every head's K and V past the effective L2: each row-block pass refetches
    enc = analyze_sm90(_fwd(L=1500, B=4, H_kv=20, G=1, D=64, causal=False), kernel="flash_fwd")
    assert enc.dram_bytes > enc.dram_bytes_ideal
    small = analyze_sm90(_fwd(L=512), kernel="flash_fwd")
    assert small.dram_bytes == small.dram_bytes_ideal
    assert small.bottleneck == "latency" and small.waves < 1
    # splits past the card's resident slots cost another wave
    d = _dec(S=520, B=4, H_kv=32, G=1, D=112)
    assert analyze_sm90(d, kernel="flash_decode", n_split=2).waves <= 1
    assert analyze_sm90(d, kernel="flash_decode", n_split=3).waves > 1


@pytest.mark.parametrize("D", [16, 64, 112, 128])
def test_plan_fits_shared_memory_and_the_built_set(D):
    w = _fwd(L=2048, H_kv=8, G=4, D=D)
    plan = autotune_flash(w)
    assert plan.smem_bytes <= sm90.SMEM_PER_BLOCK == 232448
    assert plan.stages in sm90.FWD.built(D)
    assert sorted(c.stages for c in flash_candidates(w, causal=True)) == list(sm90.FWD.built(D))
    assert sm90.ctas_per_sm("flash_fwd", D, stages=plan.stages) == 1
    assert sm90.smem_bytes("flash_fwd", 128, 3) == 230504


def test_autotune_sim_agrees_with_shortlist():
    plan = autotune_flash(_fwd(L=1024), use_sim=True, top_k=2)
    assert plan.sim_us is not None and plan.sim_us > 0
    dplan = autotune_decode(_dec(S=1024), use_sim=True, top_k=2, max_ctas=16)
    assert dplan.sim_us is not None and dplan.sim_us > 0
    assert dplan.n_split in [c.n_split for c in decode_candidates(_dec(S=1024))[:2]]


@settings(max_examples=20, deadline=None)
@given(rows=st.sampled_from([16, 64, 128]), cols=st.sampled_from([8, 64, 128]))
def test_softmax_cycles_scale(rows, cols):
    base = sm90.softmax_cycles(rows, cols)
    assert base > 0
    assert sm90.softmax_cycles(2 * rows, cols) >= base
    assert sm90.softmax_cycles(rows, 2 * cols) >= base


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

GRID = [(model, seqlen, causal) for model in ("8B", "70B", "405B")
        for seqlen in (512, 2048, 8192) for causal in (False, True)]


@pytest.mark.parametrize("model,seqlen,causal", GRID)
def test_flops_equal_the_jax_packages_models(model, seqlen, causal):
    jw = jllama3.workload(model, seqlen, batch=2, causal=causal)
    w = AttnWorkload(**dataclasses.asdict(jw))
    rep = analyze_sm90(w, kernel="flash_fwd")
    assert rep.flops == analyze_tpu(jw, causal=causal).flops
    assert rep.flops == janalytical.analyze(jw, JH800, kernel="fa3").flops


@pytest.mark.parametrize("B,Hkv,G,D,clen", [(4, 2, 8, 128, 520), (4, 32, 1, 112, 520),
                                           (1, 8, 16, 64, 37), (2, 20, 1, 64, 1500)])
def test_decode_dram_bytes_are_the_cache_q_and_o(B, Hkv, G, D, clen):
    w = _dec(S=clen, H_kv=Hkv, G=G, D=D, B=B)
    for n in (1, min(16, -(-clen // 16))):
        rep = analyze_sm90(w, kernel="flash_decode", n_split=n)
        assert rep.dram_bytes == 2 * 2 * B * Hkv * clen * D + 2 * 2 * B * Hkv * G * D
        assert rep.dram_bytes == rep.dram_bytes_ideal
        assert rep.ctas == B * Hkv * n
        assert rep.flops == 4.0 * B * Hkv * G * clen * D


def _decode_inputs(B, H, Hkv, S, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(dtype) for a in arrs])


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("n_split", [1, 2, 3, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("partials", [False, True])
def test_split_arithmetic_matches_the_jax_reference(n_split, dtype, partials):
    """The plain version at an explicit ``n_split`` merges the kernels' balanced
    runs of 16-row tiles by log-sum-exp; it agrees with the JAX package's
    reference decode at the tolerances of tests/test_kernels.py."""
    B, H, Hkv, S, D, clen = 2, 8, 2, 320, 64, 301       # 19 tiles, the last ragged
    (q, kc, vc), (qj, kcj, vcj) = _decode_inputs(B, H, Hkv, S, D, dtype, seed=41)
    got = tops.decode_forward(q, kc, vc, clen, mode="reference", n_split=n_split,
                              return_partials=partials)
    want = jops.decode_forward(qj, kcj, vcj, clen, mode="reference",
                               return_partials=partials)
    if partials:
        acc, m, l = got
        accj, mj, lj = want
        f32 = _tol("float32")
        _close(m, mj, f32)
        _close(l, lj, f32)
        _close(acc, accj, f32)
        assert torch.equal(torch.stack([m, l]), torch.stack(
            tfd.flash_decode(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), clen,
                             return_partials=True, n_split=n_split)[1:]))
    else:
        assert got.dtype == q.dtype
        _close(got, want, _tol(dtype))


def test_split_rule_default_is_unchanged():
    (q, kc, vc), _ = _decode_inputs(2, 8, 2, 320, 64, "float32", seed=42)
    qt, kt, vt = q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2)
    o = tfd.flash_decode_plain(qt, kt, vt, 301)
    assert torch.equal(tfd.flash_decode(qt, kt, vt, 301, n_split=None), o)
    assert torch.allclose(tfd.flash_decode_plain(qt, kt, vt, 301, n_split=1), o,
                          atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the wrappers' argument checks
# ---------------------------------------------------------------------------

def test_wrappers_refuse_settings_the_kernels_refuse():
    (q, kc, vc), _ = _decode_inputs(1, 4, 2, 64, 64, "bfloat16", seed=43)
    qt, kt, vt = q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2)
    before = (tfd.launches, tfa.launches)
    for bad in (0, -1, 5, 17, 2.0, True):      # 40 rows are 3 tiles
        for fn in (tfd.flash_decode, tfd.flash_decode_plain):
            with pytest.raises(ValueError, match="n_split"):
                fn(qt, kt, vt, 40, n_split=bad)
        with pytest.raises(ValueError, match="n_split"):
            tops.decode_forward(q, kc, vc, 40, n_split=bad)
    tfd.flash_decode(qt, kt, vt, 40, n_split=3)              # 3 tiles: 3 splits
    with pytest.raises(ValueError, match="n_split"):
        tfd.flash_decode(qt, kt, vt, 1000, n_split=17)       # past one cluster
    x = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    x112 = torch.zeros(1, 2, 64, 112, dtype=torch.bfloat16)
    for bad, t in ((4, x112), (1, x), (5, x), (3.0, x)):
        for fn in (tfa.flash_attention, tfa.flash_attention_plain):
            with pytest.raises(ValueError, match="stages"):
                fn(t, t, t, causal=True, stages=bad)
    with pytest.raises(ValueError, match="stages"):
        tops.mha_forward(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2), stages=5)
    f32 = x.float()
    for fn in (tfa.flash_attention, tfa.flash_attention_plain):
        with pytest.raises(ValueError, match="bf16"):
            fn(f32, f32, f32, stages=2)
    for D, depths in ((64, (2, 3, 4)), (112, (2, 3))):
        t = torch.zeros(1, 2, 64, D, dtype=torch.bfloat16)
        for s in depths:
            assert torch.equal(tfa.flash_attention(t, t, t, stages=s),
                               tfa.flash_attention_plain(t, t, t))
    assert (tfd.launches, tfa.launches) == before


@settings(max_examples=40, deadline=None)
@given(B=st.integers(1, 8), Hkv=st.sampled_from([1, 2, 8, 32]), G=st.sampled_from([1, 4, 8, 16]),
       D=st.sampled_from([16, 64, 112, 128]), clen=st.integers(1, 40000))
def test_plans_stay_legal(B, Hkv, G, D, clen):
    """Whatever the shape, neither autotuner returns a setting the wrappers refuse."""
    plan = autotune_decode(_dec(S=clen, H_kv=Hkv, G=G, D=D, B=B))
    tfd.check_n_split(plan.n_split, clen)
    fplan = autotune_flash(_fwd(L=min(clen, 4096), H_kv=Hkv, G=G, D=D, B=B))
    tfa.check_stages(fplan.stages, D, torch.bfloat16)


# ---------------------------------------------------------------------------
# the model's constants against the kernels' sources
# ---------------------------------------------------------------------------

def _constants(src):
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_model_constants_match_the_kernel_sources():
    fwd_src = (CSRC / "flash_fwd_sm90.cu").read_text()
    dec_src = (CSRC / "flash_decode_sm90.cu").read_text()
    fc, dc = _constants(fwd_src), _constants(dec_src)
    for name in ("BM", "BN", "CONSUMERS", "SW", "PRODUCER_REGS", "CONSUMER_REGS"):
        assert getattr(sm90.FWD, name) == fc[name], name
    for name in ("TN", "NW", "NP", "RING", "MAX_SPLIT"):
        assert getattr(sm90.DEC, name) == dc[name], name
    # the entry point's switch: the <DP, STAGES> variants it launches, and the default
    entry = fwd_src[fwd_src.index('extern "C" int repro_flash_fwd_sm90'):]
    built = {}
    for dp, st_ in re.findall(r"launch<(\d+), (\d+)>", entry):
        built.setdefault(int(dp), []).append(int(st_))
    assert {dp: tuple(sorted(s)) for dp, s in built.items()} == dict(sm90.FWD.BUILT)
    assert dict(sm90.FWD.BUILT) == tfa.STAGES_SM90
    assert dict(sm90.FWD.DEFAULT) == tfa.DEFAULT_STAGES_SM90
    for dp, default in sm90.FWD.DEFAULT:
        # "case 0:" falls through to the default variant's launch
        assert re.search(rf"case 0:\s*(case \d+:\s*)*return launch<{dp}, {default}>", entry)
    assert sm90.DEC.TN == tfd.TILE_SM90 and sm90.DEC.MAX_SPLIT == tfd.MAX_SPLIT_SM90
    assert re.search(r"__launch_bounds__\(NTHREADS, NB == 1 \? 2 : 1\)", dec_src)
    assert sm90.ctas_per_sm("flash_decode", 128, G=8) == 2
    assert sm90.ctas_per_sm("flash_decode", 128, G=16) == 1


# ---------------------------------------------------------------------------
# the launchers and the import rule
# ---------------------------------------------------------------------------

def test_launchers_print_the_simfa_h100_line(capsys, tmp_path):
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    assert tserve.main(["--device", "cpu", "--requests", "2", "--max-new", "2"]) == 0
    out = capsys.readouterr().out
    assert "SimFA-H800" in out
    assert re.search(r"SimFA-H100 bf16 decode kernel plan: n_split \d+, [\d.]+ us", out)
    handler = signal.getsignal(signal.SIGTERM)       # the launcher installs its own
    try:
        ttrain.main(["--device", "cpu", "--reduced", "--steps", "1", "--batch", "2",
                     "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")])
    finally:
        signal.signal(signal.SIGTERM, handler)
    out = capsys.readouterr().out
    assert re.search(r"SimFA-H100 bf16 forward kernel plan: stages \d, [\d.]+ us/layer", out)


def test_sm90_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import sys
        import repro_torch.core.sm90.autotune
        import repro_torch.core.sm90.tracegen
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
