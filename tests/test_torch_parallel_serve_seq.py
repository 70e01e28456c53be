"""The sharded prefill with its residual split by sequence over ``model``
(``serve.decode.make_prefill_step(..., mesh=)`` inside an activation scope
whose residual spec names ``model`` on the sequence dim, as
``REPRO_PERF``'s ``seq_shard_acts`` plan of command-r-plus-104b's
``prefill_32k`` gives it: ROADMAP C38) for the dense, vlm and moe families,
on 3 or 4 gloo ranks, held to the port's one device: the prefill's and 2
decode steps' logits within 1e-5, the greedy tokens exact, in fp32 compute
at the reduced widths.

The jobs cover each layout the gathered sequence meets: the q and kv heads
split, the cache by kv heads (olmo-1b on 2 x 2); the q heads split and the
kv heads not, the cache by sequence, every kv head projected on each rank
(qwen2.5-3b on (1, 4), the ``every_kv`` layout of command-r-plus-104b's 8 kv
heads at tp 16); the heads whole, the attention alike on every rank on the
gathered sequence (minicpm-2b on (1, 3), ``d_ff`` 96); the MoE dispatch over
the gathered rows of both data ranks (dbrx-132b on 2 x 2, its dropped
choices one device's); and a VLM's prefix (pixtral-12b on 2 x 2: 8 prefix
positions and 6 tokens, 7 a rank). The qwen job is also held to the JAX
package's prefill step. The rank worker is
``tests/torch_sharded_serve_worker.py`` (its ``residual`` job key). The
decision (``serve.decode.seq_split``) and the dry-run of the ``REPRO_PERF``
cell are tested alone.
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch import compat
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi
from repro_torch.parallel import ctx as pctx
from repro_torch.serve import decode as tdecode

from test_torch_models import reference_mlp_follows_compute_dtype  # noqa: F401
from test_torch_parallel import FakeMesh
from test_torch_parallel_serve import ROOT, TOL, _cfg, _env, _jax_logits, _run_ranks
from torch_sharded_serve_worker import one_device, serve_inputs

SP = ["data", "model", None]
STEPS = 2
JOBS = {
    "olmo-1b-sp": dict(arch="olmo-1b", mesh=[2, 2], batch=4, prompt=10, max_seq=32,
                       residual=SP),
    "qwen2.5-3b-tp4-sp": dict(arch="qwen2.5-3b", mesh=[1, 4], batch=2, prompt=12, max_seq=32,
                              residual=SP),
    "minicpm-2b-tp3-sp": dict(arch="minicpm-2b", mesh=[1, 3], batch=2, prompt=9, max_seq=24,
                              replace={"d_ff": 96}, residual=SP),
    "dbrx-132b-sp": dict(arch="dbrx-132b", mesh=[2, 2], batch=4, prompt=10, max_seq=32,
                         residual=SP),
    "pixtral-12b-sp": dict(arch="pixtral-12b", mesh=[2, 2], batch=4, prompt=6, max_seq=32,
                           residual=SP),
}
# the dry-run's unsplit yardstick of command-r-plus-104b's prefill_32k under
# REPRO_PERF=1 (the same plan with the residual whole: the steps before the
# split, with the knobs' meta repair): (peak bytes, FLOPs) a device, by mesh
YARDSTICK = {"single_pod_16x16": (50_900_025_344, 1_444_759_065_329_664),
             "multi_pod_2x16x16": (33_451_327_488, 722_379_532_664_832)}

_RUNS = {}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``served(name)``: job ``name``'s rank 0 output, and the unsharded
    steps' tokens and ``Recorder`` over the same weights and prompts (each
    job run once a module)."""
    def run(name):
        if name not in _RUNS:
            job = JOBS[name]
            out = _run_ranks(tmp_path_factory.mktemp(name), job, steps=STEPS)
            cfg = _cfg(job)
            inputs = serve_inputs(cfg, job["batch"], job["prompt"])
            toks, rec = one_device(cfg, tapi.init(cfg, 0, device="cpu"), inputs,
                                   job["max_seq"], STEPS)
            _RUNS[name] = (name, out, toks, rec)
        return _RUNS[name]
    return run


EVERY_JOB = pytest.mark.parametrize("name", list(JOBS))


def _positions(job):
    cfg = _cfg(job)
    return job["prompt"] + (cfg.frontend_len if cfg.family == "vlm" else 0)


@EVERY_JOB
def test_split_prefill_matches_one_device(served, name):
    """The split prefill's and 2 decode steps' logits within 1e-5 of one
    device, the greedy tokens equal, no parameter gathered whole."""
    name, out, toks, rec = served(name)
    assert len(out["logits"]) == len(rec.logits) == 1 + STEPS
    for i, (got, want) in enumerate(zip(out["logits"], rec.logits)):
        np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{name} step {i}")
    np.testing.assert_array_equal(np.asarray(out["tokens"]), toks.numpy())


@EVERY_JOB
def test_the_prefill_splits_the_residual_and_the_decode_does_not(served, name):
    """``serve.decode.seq_split`` holds for the job, and on every rank each
    block of the prefill takes the model rank's ``S/tp`` rows (the VLM's
    prefix counted) with the residual split, each block of a decode step one
    row with it whole."""
    name, out, _, _ = served(name)
    job = JOBS[name]
    S, tp = _positions(job), job["mesh"][1]
    assert out["seq_split"] == [True, {}]
    for r in out["ranks"]:
        assert r["block_rows"] == [[1, False], [S // tp, True]]


@EVERY_JOB
def test_the_split_prefill_fills_every_position_of_the_cache(served, name):
    """Each rank's cache after the split prefill: ``idx`` the prompt's
    positions (not the rank's rows), and its block of the K stack holding
    exactly the prompt's positions that fall there, from its first."""
    name, out, _, _ = served(name)
    job = JOBS[name]
    S = _positions(job)
    for r in out["ranks"]:
        first, count = r["block"]["seq"]
        n = min(max(S - first, 0), count)
        assert r["prefill_cache"] == {"idx": S, "filled": list(range(n))}
    if name == "qwen2.5-3b-tp4-sp":             # by sequence: 8, 4, 0 and 0 rows
        assert [r["prefill_cache"]["filled"] for r in out["ranks"]] == [
            list(range(8)), list(range(4)), [], []]


def test_the_split_moe_dispatch_drops_one_devices_choices(served):
    """dbrx on 2 x 2: the prefill's 2 x 10 tokens a data rank, 5 positions a
    model rank, are gathered over both data ranks' and both model ranks' rows
    into one device's group of 40 (C40), with its capacity and its dropped
    choices at every layer; each decode step's 4 slots likewise."""
    name, out, _, rec = served("dbrx-132b-sp")
    cfg = _cfg(JOBS[name])
    assert out["moe_groups"] == rec.groups
    assert [g[:2] for g in out["moe_groups"]] == (
        [[40, 40]] * cfg.num_layers + [[4, 4]] * cfg.num_layers * STEPS)
    assert any(g[2] for g in out["moe_groups"])


def test_split_prefill_matches_the_jax_package(served, monkeypatch,
                                               reference_mlp_follows_compute_dtype):
    """qwen2.5-3b on (1, 4), its prefill split by sequence, against the JAX
    package's ``make_prefill_step`` and ``make_serve_step`` on one device from
    the same weights: logits within 1e-5, tokens exact."""
    name, out, _, _ = served("qwen2.5-3b-tp4-sp")
    job = JOBS[name]
    cfg = _cfg(job)
    cfg_j = dataclasses.replace(jregistry.get(job["arch"]).reduced(), compute_dtype="float32")
    tree = compat.params_to_jax(cfg, tapi.init(cfg, 0, device="cpu"))
    toks, logits = _jax_logits(monkeypatch, cfg_j, jax.tree.map(jnp.asarray, tree),
                               serve_inputs(cfg, job["batch"], job["prompt"]), job["max_seq"],
                               steps=STEPS)
    np.testing.assert_array_equal(np.asarray(out["tokens"]), toks)
    assert len(logits) == len(out["logits"])
    for got, want in zip(out["logits"], logits):
        np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the decision, and the dry-run
# ---------------------------------------------------------------------------

def _batch(arch, tokens):
    cfg = tregistry.get(arch)
    out = {"tokens": torch.empty(1, tokens, device="meta")}
    if cfg.family in ("vlm", "encdec"):
        out["embeds" if cfg.family == "vlm" else "frames"] = torch.empty(
            1, cfg.frontend_len, cfg.d_model, device="meta")
    return cfg, out


# whether the encoder's stack splits inside the scope, by its 1500 frames at tp
# (C33: 16 does not divide them, 4 does)
ENCODER_SPLIT = {16: False, 4: True}


@pytest.mark.parametrize("arch,tokens,tp,want", [
    ("command-r-plus-104b", 32768, 16, True),      # the REPRO_PERF cell
    ("olmo-1b", 30, 16, False),                    # 16 does not divide 30 (C33)
    ("olmo-1b", 30, 3, True),
    ("dbrx-132b", 32768, 16, True),
    ("pixtral-12b", 32768 - 1024, 16, True),       # 1024 prefix positions counted
    ("pixtral-12b", 32768, 16, True),
    ("pixtral-12b", 32760, 16, False),
    ("zamba2-7b", 32768, 16, True),                # C38b closed: the hybrid, ssm and
    ("rwkv6-7b", 32768, 16, True),                 # encdec prefills split as the others
    ("whisper-large-v3", 32768, 16, True),         # the decoder split, the encoder whole
    ("whisper-large-v3", 32768, 4, True),          # both stacks split (375 frames a rank)
    ("zamba2-7b", 32760, 16, False),               # 16 does not divide 32760
])
def test_the_serving_decision(arch, tokens, tp, want):
    """``serve.decode.seq_split`` under a residual spec that names ``model``
    on the sequence dim: true where tp divides the positions (a VLM's prefix
    counted), for every family, an encoder-decoder's encoder by its own
    frames; false where tp does not divide, and for every family outside the
    scope. It is the train step's answer (``trainer.seq_split``), the same
    rule."""
    from repro_torch.train import trainer as ttrainer
    cfg, batch = _batch(arch, tokens)
    mesh = FakeMesh(data=2, model=tp)
    whole = {"encoder": False} if "frames" in batch else {}
    split = {"encoder": ENCODER_SPLIT[tp]} if "frames" in batch else {}
    assert tdecode.seq_split(cfg, mesh, batch) == (False, whole)
    with pctx.activation_sharding(residual=("data", "model", None)):
        assert tdecode.seq_split(cfg, mesh, batch) == (want, split)
        train = ttrainer.seq_split(cfg, mesh, batch)
        assert tdecode.seq_split(cfg, mesh, batch) == train
    assert train[0] == (pctx.residual_len(batch) % tp == 0)
    with pctx.activation_sharding(residual=("data", None, None)):
        assert tdecode.seq_split(cfg, mesh, batch) == (False, whole)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_the_dry_run_counts_the_repro_perf_prefill_split(tmp_path, mesh):
    """``REPRO_PERF=1 python -m repro_torch.launch.dryrun --arch
    command-r-plus-104b --shape prefill_32k``: the cell's plan sets
    ``seq_shard_acts`` and the ``attn_chunk`` / ``attn_pv_bf16`` knobs, which
    map to the plain ``flash_ref`` on the meta tensors (they computed
    nothing, and raised before). The record is ``ok``, the residual split:
    its peak a device below the unsplit plan's, its FLOPs within 1 %."""
    out = tmp_path / "dryrun.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "command-r-plus-104b", "--shape", "prefill_32k",
                        "--mesh", mesh, "--out", str(out)],
                       cwd=ROOT, env={**_env(), "REPRO_PERF": "1"}, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    (rec,) = json.loads(out.read_text()).values()
    assert rec["status"] == "ok" and rec["plan"]["seq_shard_acts"]
    peak, flops = YARDSTICK[rec["mesh"]]
    assert rec["mem"]["peak_bytes"] < peak
    assert rec["flops_per_device"] == pytest.approx(flops, rel=0.01)
