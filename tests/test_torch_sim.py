"""The port's copy of the Sim-FA simulator against the reference, in one process.

``repro_torch.{core,obs,analysis,faults,utils}`` is a copy of the JAX
package's jax-free simulator (``core/tpu/`` excepted) with ``repro.`` read
as ``repro_torch.``; ``repro_torch.data.synthetic`` (the numpy-only data
pipeline of the training path) is a verbatim copy held by the same drift
check. Two kinds of check hold them there:

* parity: the same workloads through ``repro.core`` and ``repro_torch.core``
  give equal results, exactly (the engine counts integers and both copies
  do the same float arithmetic);
* drift: each copied module's source equals the reference module's source
  after the rewrite, except for the deviations listed in ``DEVIATIONS``;
  ``obs/spans.py`` is the port's own (its layers' profiler spans).

The simulator suites themselves (test_engine_equiv, test_kprog, test_faults,
...) run against the reference only; these few cases tie the copy to it.
"""
import dataclasses
import pathlib
import re

import pytest

from repro.analysis import dag as jdag
from repro.analysis import whatif as jwhatif
from repro.configs import llama3 as jllama3
from repro.core import analytical as janalytical
from repro.core import isa as jisa
from repro.core import machine as jmachine
from repro.core import simfa as jsimfa
from repro.core.kprog import registry as jregistry
from repro.core.kprog import verify as jverify
from repro.core.tracegen_fa3 import FA3Tiling as JTiling
from repro_torch.analysis import dag as tdag
from repro_torch.analysis import whatif as twhatif
from repro_torch.configs import llama3 as tllama3
from repro_torch.core import analytical as tanalytical
from repro_torch.core import isa as tisa
from repro_torch.core import machine as tmachine
from repro_torch.core import simfa as tsimfa
from repro_torch.core.kprog import registry as tregistry
from repro_torch.core.kprog import verify as tverify
from repro_torch.core.tracegen_fa3 import FA3Tiling as TTiling
from repro_torch.obs import manifest as tmanifest

REF = pathlib.Path(jsimfa.__file__).parents[1]          # src/repro
PORT = pathlib.Path(tsimfa.__file__).parents[1]         # src/repro_torch

# (package path of a module) -> [(reference text after the rewrite, port text, why)]
DEVIATIONS = {
    "obs/manifest.py": [
        ('"/repro/"', '"/repro_torch/"',
         "the copy's frames lie under repro_torch/: matching /repro/ would file all of "
         "the copy's own time under stdlib/other in subsystem_wall_breakdown"),
    ],
    "obs/__init__.py": [
        ("    simulate/sweep/bench artifact.\n",
         "    simulate/sweep/bench artifact;\n"
         "  * :mod:`repro_torch.obs.spans` — the port's own layers (engine, serve\n"
         "    steps, model, kernel seam, trainer) as named host ranges in an active\n"
         "    ``torch.profiler`` session, on the card's clock; a no-op otherwise.\n",
         "the docstring names obs/spans.py, the port's own module beside the copy"),
    ],
}


def copied_modules():
    """Every module of the reference's simulator that the port holds a copy of,
    and the data pipeline."""
    names = ["utils/ioutil.py", "data/synthetic.py"]
    for pkg in ("obs", "analysis", "faults", "core", "core/kprog"):
        names += sorted(p.relative_to(REF).as_posix() for p in (REF / pkg).glob("*.py"))
    return names


def rewrite(text):
    return re.sub(r"\brepro\.", "repro_torch.", text)


@pytest.mark.parametrize("module", copied_modules())
def test_copy_matches_reference_source(module):
    want = rewrite((REF / module).read_text())
    for old, new, _why in DEVIATIONS.get(module, ()):
        assert old in want, f"{module}: the listed deviation {old!r} is gone from the reference"
        want = want.replace(old, new)
    assert (PORT / module).read_text() == want


def test_no_tpu_model_and_nothing_uncopied():
    assert not (PORT / "core" / "tpu").exists()
    held = {p.relative_to(PORT).as_posix()
            for pkg in ("obs", "analysis", "faults", "core", "core/kprog", "utils", "data")
            for p in (PORT / pkg).glob("*.py")}
    assert held == set(copied_modules()) | {"utils/__init__.py", "utils/cost.py",
                                            "data/__init__.py", "obs/spans.py"}


def test_subsystem_breakdown_names_the_copys_layers():
    """Why obs/manifest.py deviates: the copy's own frames are filed by layer."""
    assert tmanifest._subsystem_of(str(PORT / "core" / "engine.py")) == "core.engine"
    assert tmanifest._subsystem_of(str(PORT / "core" / "kprog" / "fa3.py")) == "core.kprog"
    assert tmanifest._subsystem_of(str(PORT / "models" / "api.py")) == "repro_torch.other"


# ---------------------------------------------------------------------------
# parity: simulate_fa3
# ---------------------------------------------------------------------------

# name -> (kernel, h800_variant kwargs, workload kwargs, tiling kwargs or None):
# the small grids of tests/test_engine_equiv.py (CONFIGS and KERNEL_CONFIGS),
# launched on the whole machine through simulate_fa3
SIM_CASES = {
    "tiny": ("fa3", {}, dict(B=1, L=128, S=256, H_kv=1, G=1, D=64),
             dict(t_m=64, t_n=128, stages=2)),
    "small": ("fa3", {}, dict(B=1, L=256, S=512, H_kv=1, G=2, D=128), None),
    "causal": ("fa3", dict(tma_max_inflight_lines=8, lrc_enabled=False),
               dict(B=1, L=256, S=512, H_kv=1, G=1, D=128, causal=True), None),
    "nox": ("fa3", dict(xor_hash=False, remote_copy=False),
            dict(B=1, L=192, S=384, H_kv=1, G=1, D=64), dict(t_m=64, t_n=96, stages=3)),
    "kernel-fa3": ("fa3", {}, dict(B=1, L=256, S=512, H_kv=1, G=2, D=128), None),
    "kernel-fa3_cooperative": ("fa3_cooperative", dict(num_sms=4),
                               dict(B=1, L=256, S=512, H_kv=1, G=2, D=128), None),
    "kernel-fa2": ("fa2", {}, dict(B=1, L=192, S=384, H_kv=1, G=1, D=64), None),
    "kernel-splitkv_decode": ("splitkv_decode", {},
                              dict(B=2, L=1, S=2048, H_kv=2, G=4, D=128), None),
}
SIM_KEYS = ("cycles", "latency_us", "fidelity", "n_ctas_total", "n_ctas_simulated",
            "mem_fidelity", "tc_util", "l2_bytes", "l2_delivered_bytes", "dram_bytes",
            "l2_stats", "deadlocked", "kernel", "aborted")


def _simulate(pkg, name, **opts):
    kernel, machine_kw, w_kw, tiling_kw = SIM_CASES[name]
    llama3, machine, simfa, tiling_cls = pkg
    w = llama3.AttnWorkload(name=name, **w_kw)
    cfg = machine.h800_variant(**machine_kw)
    tiling = tiling_cls(**tiling_kw) if tiling_kw else None
    return simfa.simulate_fa3(w, cfg, tiling=tiling, kernel=kernel, **opts), cfg


JAX_SIDE = (jllama3, jmachine, jsimfa, JTiling)
PORT_SIDE = (tllama3, tmachine, tsimfa, TTiling)


@pytest.mark.parametrize("name", sorted(SIM_CASES))
def test_simulate_matches_reference(name):
    want, cfg = _simulate(JAX_SIDE, name, fidelity="full")
    got, _ = _simulate(PORT_SIDE, name, fidelity="full")
    assert not got.deadlocked and got.cycles > 0
    # the engine's counters: cycles, DRAM bytes, L2 request bytes, TMA lines
    assert (got.cycles, got.dram_bytes, got.l2_delivered_bytes, got.l2_bytes / cfg.line_bytes) \
        == (want.cycles, want.dram_bytes, want.l2_delivered_bytes, want.l2_bytes / cfg.line_bytes)
    assert {k: getattr(got, k) for k in SIM_KEYS} == {k: getattr(want, k) for k in SIM_KEYS}


ANCHOR_W = dict(B=1, L=1024, S=2048, H_kv=2, G=2, D=128)


@pytest.mark.parametrize("fidelity, anchor", [
    ("full", {"cycles": 73614, "dram_bytes": 4194304, "l2_req_bytes": 31705728,
              "tma_lines": 565248}),
    ("tile", {"cycles": 72792, "dram_bytes": 4194304, "l2_req_bytes": 31170560,
              "tma_lines": 565248}),
])
def test_reference_launch_anchors(fidelity, anchor):
    """The pinned reference FA3 launch, through the port's simulator only."""
    w = tllama3.AttnWorkload(name="full", **ANCHOR_W)
    res = tsimfa.simulate_fa3(w, tmachine.H800, fidelity=fidelity)
    assert res.fidelity == fidelity and not res.deadlocked
    got = {"cycles": res.cycles, "dram_bytes": res.dram_bytes,
           "l2_req_bytes": res.l2_delivered_bytes,
           "tma_lines": res.l2_bytes // tmachine.H800.line_bytes}
    assert got == anchor


# ---------------------------------------------------------------------------
# parity: analytical model, registry, verifier, what-if replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["8B", "70B", "405B"])
@pytest.mark.parametrize("kernel", ["fa3", "fa3_cooperative", "splitkv_decode"])
def test_analytical_matches_reference_on_llama3_grid(kernel, model):
    for seqlen in (512, 2048, 8192, 32768):
        for causal in (False, True):
            for batch in (1, 4):
                jw = jllama3.workload(model, seqlen, batch=batch, causal=causal)
                tw = tllama3.workload(model, seqlen, batch=batch, causal=causal)
                if kernel == "splitkv_decode":
                    jw, tw = (dataclasses.replace(x, L=1, causal=False) for x in (jw, tw))
                want = janalytical.analyze(jw, jmachine.H800, kernel=kernel)
                got = tanalytical.analyze(tw, tmachine.H800, kernel=kernel)
                assert (got.latency, got.dram_bytes, got.bottleneck) == \
                    (want.latency, want.dram_bytes, want.bottleneck), (seqlen, causal, batch)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_registry_lists_the_same_kernels():
    assert tregistry.available() == jregistry.available()
    assert tregistry.available() == ["fa2", "fa3", "fa3_cooperative", "splitkv_decode"]


def _dropped_release_report(registry, verify, isa, machine):
    """fa3's probe CTA with consumer0's first stage release removed, verified
    (as tests/test_verify.py's dropped-release mutation)."""
    spec = registry.get("fa3", verify=False)
    trace = spec.build(machine.H800, spec.probe_workload())[0][0]
    ci = trace.roles.index("consumer0")
    wgs = [list(w) for w in trace.wgs]
    first = next(i for i, ins in enumerate(wgs[ci]) if ins.op == isa.RELEASE_STAGE)
    del wgs[ci][first]
    bad = dataclasses.replace(trace, wgs=[tuple(w) for w in wgs])
    return verify.verify_ctas([bad], kernel="fa3-droprel")


def test_dropped_release_finding_matches_reference():
    want = _dropped_release_report(jregistry, jverify, jisa, jmachine)
    got = _dropped_release_report(tregistry, tverify, tisa, tmachine)
    assert not got.ok
    assert tverify.DEADLOCK in got.codes() and tverify.WAIT_RELEASE_MISMATCH in got.codes()
    assert got.codes() == want.codes()
    dl_got = next(f for f in got.errors if f.code == tverify.DEADLOCK)
    dl_want = next(f for f in want.errors if f.code == jverify.DEADLOCK)
    assert dl_got.witness and any("consumer0" in hop for hop in dl_got.witness)
    assert (dl_got.witness, dl_got.pc, dl_got.op, dl_got.cta, dl_got.wg) == \
        (dl_want.witness, dl_want.pc, dl_want.op, dl_want.cta, dl_want.wg)
    assert got.render() == want.render()


def test_whatif_identity_replay_matches_reference():
    """A x1.0 replay of the port's DAG is exact and within 1 % of the simulated
    makespan, and the reference's run gives the same DAG makespan."""
    makespans = []
    for llama3, machine, simfa, dag_mod, whatif in (
            (jllama3, jmachine, jsimfa, jdag, jwhatif),
            (tllama3, tmachine, tsimfa, tdag, twhatif)):
        w = llama3.AttnWorkload(name="id", B=1, L=128, S=512, H_kv=1, G=2, D=128)
        res = simfa.simulate_fa3(w, machine.H800, fidelity="full", record_events=True)
        dag = dag_mod.build(res.trace.events, res.trace.dispatch_parent)
        r = whatif.replay(dag)
        assert r.makespan == dag.makespan
        assert abs(r.makespan - res.cycles) / res.cycles <= 0.01
        makespans.append((res.cycles, dag.makespan))
    assert makespans[0] == makespans[1]
