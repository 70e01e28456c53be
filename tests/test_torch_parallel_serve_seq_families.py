"""The sharded prefill with its residual split by sequence over ``model``
(``serve.decode.make_prefill_step(..., mesh=)`` inside an activation scope
whose residual spec names ``model`` on the sequence dim, as a ``prefill_32k``
plan with ``seq_shard_acts`` set gives it: ROADMAP C38b) for the hybrid
(zamba2-7b), ssm (rwkv6-7b) and encdec (whisper-large-v3) families, on 3 or
4 gloo ranks, held to the port's one device: the prefill's and 2 decode
steps' logits within 1e-5, the greedy tokens exact, and every rank's block
of the prefill's cache (each Mamba2 ``conv`` / ``ssm`` state, each RWKV6
``S`` state and token-shift carry, the K/V stacks and whisper's cross cache)
one device's block of it, in fp32 compute at the reduced widths.

The jobs cover each layout the gathered sequence meets: zamba2 on 2 x 2 with
its 2 Mamba2 heads and 4 attention heads split (``layers.split_input``, the
rank-major conv state), at chunk 8 over 20 positions (three SSD chunks, the
last padded); zamba2 on (1, 3), where neither splits and each layer runs
alike on every rank on the gathered sequence; rwkv6 on 2 x 2 (heads split,
80 positions: two WKV chunks) and on (1, 3) with ``d_ff`` 96 (heads whole,
``d_ff`` split); whisper on (1, 4) with its frames and tokens both split
(8 frames, 2 a rank), and with 6 heads and 6 frames, the encoder whole and
the decoder split (C33, C34). One job of each family is also held to the
JAX package's serve steps. The rank worker is
``tests/torch_sharded_serve_worker.py`` (its ``residual`` and ``states`` job
keys). One cell's dry-run with ``seq_shard_acts`` set is tested here too.
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
from repro_torch import compat, tree
from repro_torch.models import api as tapi
from repro_torch.parallel import sharding as shd
from repro_torch.serve import decode as tdecode

from test_torch_models import reference_mlp_follows_compute_dtype  # noqa: F401
from test_torch_parallel_serve import ROOT, TOL, _cfg, _env, _jax_logits, _run_ranks
from test_torch_parallel_serve_families import FakeMesh
from torch_sharded_serve_worker import one_device, serve_inputs

SP = ["data", "model", None]
STEPS = 2
WHISPER_6 = {"num_heads": 6, "num_kv_heads": 6, "frontend_len": 6}
JOBS = {
    "zamba2-7b-sp": dict(arch="zamba2-7b", mesh=[2, 2], batch=4, prompt=20, max_seq=32,
                         replace={"ssm_chunk": 8}),
    "zamba2-7b-tp3-sp": dict(arch="zamba2-7b", mesh=[1, 3], batch=2, prompt=18, max_seq=24,
                             replace={"ssm_chunk": 8}),
    "rwkv6-7b-sp": dict(arch="rwkv6-7b", mesh=[2, 2], batch=4, prompt=80, max_seq=96),
    "rwkv6-7b-tp3-sp": dict(arch="rwkv6-7b", mesh=[1, 3], batch=2, prompt=18, max_seq=24,
                            replace={"d_ff": 96}),
    "whisper-large-v3-tp4-sp": dict(arch="whisper-large-v3", mesh=[1, 4], batch=2, prompt=8,
                                    max_seq=32),
    "whisper-large-v3-tp4-frames-whole-sp": dict(arch="whisper-large-v3", mesh=[1, 4],
                                                 batch=2, prompt=8, max_seq=32,
                                                 replace=WHISPER_6),
}
JOBS = {k: dict(v, residual=SP, states=True) for k, v in JOBS.items()}
# one job of each family, also held to the JAX package's serve steps
JAX_JOBS = ["zamba2-7b-sp", "rwkv6-7b-sp", "whisper-large-v3-tp4-sp"]
# the block of each family's residual stack whose input rows the worker notes
# (``STACK_BLOCKS``' key; whisper's encoder blocks are "enc")
RESIDUAL_BLOCK = {"hybrid": "mamba", "ssm": "rwkv", "encdec": "dec"}

_RUNS = {}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``served(name)``: job ``name``'s rank 0 output, the unsharded steps'
    tokens and ``Recorder`` over the same weights and prompts, and the
    unsharded prefill's cache (each job run once a module)."""
    def run(name):
        if name not in _RUNS:
            job = JOBS[name]
            out = _run_ranks(tmp_path_factory.mktemp(name), job, steps=STEPS)
            cfg = _cfg(job)
            params = tapi.init(cfg, 0, device="cpu")
            inputs = serve_inputs(cfg, job["batch"], job["prompt"])
            toks, rec = one_device(cfg, params, inputs, job["max_seq"], STEPS)
            _, cache = tdecode.make_prefill_step(cfg, max_seq=job["max_seq"])(
                params, {k: torch.from_numpy(v) for k, v in inputs.items()})
            _RUNS[name] = (name, out, toks, rec, cache)
        return _RUNS[name]
    return run


EVERY_JOB = pytest.mark.parametrize("name", list(JOBS))


def _encoder_split(job):
    """Whether the job's encoder stack splits: tp divides its frames (C33)."""
    return _cfg(job).frontend_len % job["mesh"][1] == 0


@EVERY_JOB
def test_split_prefill_matches_one_device(served, name):
    """The split prefill's and 2 decode steps' logits within 1e-5 of one
    device, the greedy tokens equal, no parameter gathered whole."""
    name, out, toks, rec, _ = served(name)
    assert len(out["logits"]) == len(rec.logits) == 1 + STEPS
    for i, (got, want) in enumerate(zip(out["logits"], rec.logits)):
        np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{name} step {i}")
    np.testing.assert_array_equal(np.asarray(out["tokens"]), toks.numpy())


@EVERY_JOB
def test_each_stack_of_the_prefill_takes_its_rows(served, name):
    """``serve.decode.seq_split`` holds for the job (whisper's encoder where
    tp divides its frames), and on every rank each block of the prefill's
    stacks (a Mamba2 layer and zamba2's shared attention block, an RWKV6
    layer, whisper's encoder and decoder blocks) takes the model rank's
    ``S/tp`` rows with the residual split, or the whole stack where it does
    not split; each block of a decode step one row with it whole. The cache's
    ``idx`` is the prompt's positions, not the rank's rows."""
    name, out, _, _, _ = served(name)
    job = JOBS[name]
    cfg, S, tp = _cfg(job), job["prompt"], job["mesh"][1]
    enc = _encoder_split(job)
    assert out["seq_split"] == [True, {"encoder": enc} if cfg.family == "encdec" else {}]
    want = {(RESIDUAL_BLOCK[cfg.family], n, split) for n, split in ((S // tp, True), (1, False))}
    if cfg.family == "encdec":
        F = cfg.frontend_len
        want.add(("enc", F // tp, True) if enc else ("enc", F, False))
    for r in out["ranks"]:
        assert {tuple(x) for x in r["stack_rows"]} == want
        assert r["block_rows"] == ([[1, False], [S // tp, True]] if cfg.family == "hybrid"
                                   else [])
        assert r["prefill_cache"]["idx"] == S


def _block_of(x, spec, mesh):
    """The block of ``x`` (the whole tensor) that ``spec`` gives the rank of
    ``mesh``."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = x.narrow(dim, *shd.entry_block(mesh, entry, x.shape[dim]))
    return x


@EVERY_JOB
def test_every_rank_holds_one_devices_block_of_the_prefill_cache(served, name):
    """Each rank's block of every leaf of the split prefill's cache is one
    device's block of it (``sharding.serve_cache_specs`` of the rank's
    coordinates, a Mamba2 ``conv`` state through its rank-major layout,
    ``sharding.rank_major_cache``), within 1e-5: the Mamba2 ``conv`` state
    (the whole sequence's last ``K - 1`` positions) and ``ssm`` state, the
    RWKV6 ``S`` state and its ``x_att`` / ``x_cmix`` carries (the whole
    sequence's last row on every rank, not the rank's last row), the self
    K/V stacks and whisper's cross cache."""
    name, out, _, _, cache = served(name)
    job = JOBS[name]
    cfg, (D, tp) = _cfg(job), job["mesh"]
    s_enc = cfg.frontend_len if cfg.family == "encdec" else None
    seen = set()
    for rank, r in enumerate(out["ranks"]):
        mesh = FakeMesh(rank={"data": rank // tp, "model": rank % tp}, data=D, model=tp)
        specs = shd.serve_cache_specs(cfg, mesh, batch=job["batch"], max_seq=job["max_seq"],
                                      s_enc=s_enc)
        major = shd.rank_major_cache(cfg, cache, mesh)
        parts = {k: v for k, v in major.items() if k != "idx"}
        paths = tree.leaves_with_paths(parts)
        assert len(paths) == len(specs) == len(r["prefill_blocks"])
        for (path, x), spec in zip(paths, specs):
            key = "/".join(map(str, path))
            np.testing.assert_allclose(np.asarray(r["prefill_blocks"][key]),
                                       _block_of(x, spec, mesh).numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {rank} {key}")
            seen.add(str(path[-1]))
    want = {"hybrid": {"conv", "ssm", "attn_k", "attn_v"}, "ssm": {"S", "x_att", "x_cmix"},
            "encdec": {"k", "v", "cross_k", "cross_v"}}[cfg.family]
    assert seen == want


@pytest.mark.parametrize("name", JAX_JOBS)
def test_split_prefill_matches_the_jax_package(served, monkeypatch, name,
                                               reference_mlp_follows_compute_dtype):
    """One job of each family, its prefill split by sequence, against the
    JAX package's ``make_prefill_step`` and ``make_serve_step`` on one device
    from the same weights: logits within 1e-5, tokens exact."""
    name, out, _, _, _ = served(name)
    job = JOBS[name]
    cfg = _cfg(job)
    cfg_j = dataclasses.replace(jregistry.get(job["arch"]).reduced(),
                                **{"compute_dtype": "float32", **job.get("replace", {})})
    params = compat.params_to_jax(cfg, tapi.init(cfg, 0, device="cpu"))
    toks, logits = _jax_logits(monkeypatch, cfg_j, jax.tree.map(jnp.asarray, params),
                               serve_inputs(cfg, job["batch"], job["prompt"]), job["max_seq"],
                               steps=STEPS)
    np.testing.assert_array_equal(np.asarray(out["tokens"]), toks)
    assert len(logits) == len(out["logits"])
    for got, want in zip(out["logits"], logits):
        np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL)


# the dry-run's unsplit yardstick of whisper-large-v3's prefill_32k on 16 x 16
# (``python -m repro_torch.launch.perf --arch whisper-large-v3 --shape
# prefill_32k --set seq_shard_acts=false``): peak bytes and FLOPs a device
YARDSTICK = (5_936_770_048, 415_804_018_657_280)


def test_the_dry_run_counts_whisper_prefill_split(tmp_path):
    """``python -m repro_torch.launch.perf --arch whisper-large-v3 --shape
    prefill_32k --set seq_shard_acts=true`` on the 16 x 16 fake group: the
    prefill splits its decoder's residual by sequence (32768 tokens, 2048 a
    model rank) and keeps the encoder whole (16 does not divide its 1500
    frames, C33). Its peak a device is below the unsplit plan's, its FLOPs
    within 1 %."""
    log = tmp_path / "perf.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.perf",
                        "--arch", "whisper-large-v3", "--shape", "prefill_32k",
                        "--set", "seq_shard_acts=true", "--log", str(log)],
                       cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    (rec,) = json.loads(log.read_text())
    assert rec["mesh"] == "single_pod_16x16" and rec["overrides"] == {"seq_shard_acts": True}
    assert rec["seq_split"] == [True, {"encoder": False}]
    peak, flops = YARDSTICK
    assert rec["peak_gb"] * 1e9 < peak
    assert rec["flops_per_device"] == pytest.approx(flops, rel=0.01)
