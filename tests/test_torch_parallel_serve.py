"""Sharded serving (``serve.decode.make_prefill_step`` / ``make_serve_step``
with ``mesh=``) for the dense, vlm and moe families on 3 or 4 gloo ranks,
held to the port's one device: the prefill's and every decode step's logits
within 1e-5, the greedy tokens exact. Each job prefills prompts shorter than
``max_seq`` and takes 4 decode steps, in fp32 compute at the reduced widths.

The jobs cover each cache layout (``sharding.cache_specs``): split by kv
heads (olmo-1b, pixtral-12b with its ``embeds`` prefix, dbrx-132b on 2 x 2,
grok-1-314b on (1, 4) with 2 experts, TP within the experts); split by
sequence with the q heads split and the kv heads not (qwen2.5-3b on (1, 4),
whose prompt leaves two of the four blocks empty); neither the q nor the kv
heads split (minicpm-2b on (1, 3): 4 heads over 3 ranks, ``d_ff`` 96 split);
and the long-context layout at batch 1 (qwen2.5-3b with 1 kv head on 2 x 2,
the sequence over data and model, the decode writing the last position, as
the dry-run's decode cell does). The dbrx job routes each decode step's
slots as one group across the data ranks (C17): its dropped choices are one
device's. The qwen (1, 4) job is also held
to the JAX package's serve steps. The pieces (the partials' merge, an empty
block, the vocabulary-split argmax) are tested alone too.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.serve import decode as jdecode
from repro_torch import compat
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn

from test_torch_models import reference_mlp_follows_compute_dtype  # noqa: F401
from torch_sharded_serve_worker import one_device, serve_inputs

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_sharded_serve_worker.py"
RANK_TIMEOUT = 300           # seconds a multi-rank run may take
TOL = 1e-5                   # logits, sharded against one device, relative / absolute
MERGE_TOL = 1e-6             # the partials' merge against one call, fp32

# (arch, mesh, batch, prompt, max_seq, replace, seq_shard)
JOBS = {
    "olmo-1b": dict(arch="olmo-1b", mesh=[2, 2], batch=4, prompt=10, max_seq=32),
    "qwen2.5-3b-tp4": dict(arch="qwen2.5-3b", mesh=[1, 4], batch=2, prompt=10, max_seq=32),
    "minicpm-2b-tp3": dict(arch="minicpm-2b", mesh=[1, 3], batch=2, prompt=7, max_seq=24,
                           replace={"d_ff": 96}),
    "pixtral-12b": dict(arch="pixtral-12b", mesh=[2, 2], batch=4, prompt=6, max_seq=32),
    "dbrx-132b": dict(arch="dbrx-132b", mesh=[2, 2], batch=4, prompt=10, max_seq=32),
    "grok-1-314b-tp4": dict(arch="grok-1-314b", mesh=[1, 4], batch=2, prompt=10, max_seq=32,
                            replace={"num_experts": 2}),
    "qwen2.5-3b-long": dict(arch="qwen2.5-3b", mesh=[2, 2], batch=1, prompt=28, max_seq=32,
                            replace={"num_kv_heads": 1}, seq_shard=True),
}
STEPS = 4


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _cfg(job):
    return dataclasses.replace(tregistry.get(job["arch"]).reduced(),
                               **{"compute_dtype": "float32", **job.get("replace", {})})


def _run_ranks(tmp_path, job, steps=STEPS):
    n = int(np.prod(job["mesh"]))
    job = dict(job, steps=steps, store=str(tmp_path / "store"), out=str(tmp_path / "out"))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(n), json.dumps(job)],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    with open(job["out"] + ".json") as f:
        return json.load(f)


_RUNS = {}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``served(name)``: job ``name``'s rank 0 output, and the unsharded
    steps' tokens and ``Recorder`` over the same weights and prompts (each
    job run once a module)."""
    def run(name):
        if name not in _RUNS:
            job = JOBS[name]
            out = _run_ranks(tmp_path_factory.mktemp(name), job)
            cfg = _cfg(job)
            inputs = serve_inputs(cfg, job["batch"], job["prompt"])
            toks, rec = one_device(cfg, tapi.init(cfg, 0, device="cpu"), inputs,
                                   job["max_seq"], STEPS)
            _RUNS[name] = (name, out, toks, rec)
        return _RUNS[name]
    return run


EVERY_JOB = pytest.mark.parametrize("name", list(JOBS))


@EVERY_JOB
def test_sharded_serving_matches_one_device(served, name):
    """The prefill's and the 4 decode steps' logits within 1e-5 of one
    device, the greedy tokens equal, no parameter gathered whole."""
    name, out, toks, rec = served(name)
    assert len(out["logits"]) == len(rec.logits) == 1 + STEPS
    for i, (got, want) in enumerate(zip(out["logits"], rec.logits)):
        np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"{name} step {i}")
    np.testing.assert_array_equal(np.asarray(out["tokens"]), toks.numpy())


@EVERY_JOB
def test_each_job_serves_the_cache_layout_its_name_says(served, name):
    """Each rank holds its block of the cache (``sharding.cache_specs``), and
    a block the filled length has not reached calls no decode kernel."""
    name, out, _, _ = served(name)
    job, cfg = JOBS[name], _cfg(JOBS[name])
    lay, ranks = out["layout"], out["ranks"]
    tp = job["mesh"][1]
    if name in ("olmo-1b", "pixtral-12b", "dbrx-132b", "grok-1-314b-tp4"):
        assert lay["kv_heads"] and all(r["block"]["seq_axes"] == [] for r in ranks)
        assert {r["cache_local_shape"][3] for r in ranks} == {cfg.num_kv_heads // tp}
        assert all(r["partials_calls"] == 0 for r in ranks)
    else:
        axes = ["data", "model"] if job.get("seq_shard") else ["model"]
        n_blocks = int(np.prod([job["mesh"][["data", "model"].index(a)] for a in axes]))
        assert all(r["block"]["seq_axes"] == axes for r in ranks)
        assert {r["cache_local_shape"][2] for r in ranks} == {job["max_seq"] // n_blocks}
        assert {r["cache_local_shape"][3] for r in ranks} == {cfg.num_kv_heads}
        for r in ranks:
            # decode step s writes position prompt + s: the block's filled rows
            # are those below prompt + s + 1
            first = r["block"]["seq"][0]
            filled = sum(job["prompt"] + s + 1 > first for s in range(STEPS))
            assert r["decode_blocks"] == cfg.num_layers * STEPS
            assert r["decode_calls"] == r["partials_calls"] == cfg.num_layers * filled
        assert any(r["decode_calls"] == 0 for r in ranks) != bool(job.get("seq_shard"))
    assert lay["heads"] == (name != "minicpm-2b-tp3")
    if name == "grok-1-314b-tp4":
        assert lay["experts"] == "tp"
    if name == "dbrx-132b":
        assert lay["experts"] == "ep"


@pytest.mark.parametrize("name", ["dbrx-132b", "grok-1-314b-tp4"])
def test_a_decode_group_spans_the_data_ranks(served, name):
    """dbrx on 2 x 2: a decode step's 4 slots, 2 a data rank, are routed as
    one group of 4 tokens (the capacity of one device's group), and its
    dropped choices are one device's; the prefill's 40 tokens likewise.
    grok on (1, 4): one data rank, the groups one device's."""
    name, out, _, rec = served(name)
    assert out["moe_groups"] == rec.groups
    if name == "dbrx-132b":
        cfg = _cfg(JOBS[name])
        assert [g[:2] for g in out["moe_groups"]] == (
            [[40, 40]] * cfg.num_layers + [[4, 4]] * cfg.num_layers * STEPS)
        assert any(g[2] for g in out["moe_groups"])               # some choices dropped


def _jax_logits(monkeypatch, cfg_j, params_j, inputs, max_seq, steps=STEPS):
    """The JAX package's serve steps on one device, a prefill of ``inputs``
    (the prompts, an encoder-decoder's frames) and ``steps`` decode steps:
    (tokens, the logits each greedy token is taken from)."""
    seen = []
    unembed, dec = japi.unembed, japi.decode

    def rec_unembed(cfg, params, hidden):
        out = unembed(cfg, params, hidden)
        seen.append(np.asarray(out, dtype=np.float32).reshape(out.shape[0], -1))
        return out

    def rec_decode(cfg, params, cache, tokens):
        logits, cache = dec(cfg, params, cache, tokens)
        seen.append(np.asarray(logits[:, -1], dtype=np.float32))
        return logits, cache

    monkeypatch.setattr(japi, "unembed", rec_unembed)
    monkeypatch.setattr(japi, "decode", rec_decode)
    tok, cache = jdecode.make_prefill_step(cfg_j, max_seq=max_seq)(
        params_j, {k: jnp.asarray(v) for k, v in inputs.items()})
    toks = [np.asarray(tok)]
    step = jdecode.make_serve_step(cfg_j)
    for _ in range(steps):
        tok, cache = step(params_j, cache, tok)
        toks.append(np.asarray(tok))
    return np.concatenate(toks, axis=1), seen


def test_sequence_split_serving_matches_the_jax_package(served, monkeypatch,
                                                        reference_mlp_follows_compute_dtype):
    """qwen2.5-3b on (1, 4), its cache split by sequence, against the JAX
    package's ``make_prefill_step`` / ``make_serve_step`` on one device from
    the same weights: logits within 1e-5, tokens exact."""
    name, out, _, _ = served("qwen2.5-3b-tp4")
    job = JOBS[name]
    cfg = _cfg(job)
    cfg_j = dataclasses.replace(jregistry.get(job["arch"]).reduced(), compute_dtype="float32")
    tree = compat.params_to_jax(cfg, tapi.init(cfg, 0, device="cpu"))
    toks, logits = _jax_logits(monkeypatch, cfg_j, jax.tree.map(jnp.asarray, tree),
                               serve_inputs(cfg, job["batch"], job["prompt"]), job["max_seq"])
    np.testing.assert_array_equal(np.asarray(out["tokens"]), toks)
    assert len(logits) == len(out["logits"])
    for got, want in zip(out["logits"], logits):
        np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def _decode_case(seed, B=2, H=8, Hkv=2, S=96, D=16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g)
    k, v = (torch.randn(B, S, Hkv, D, generator=g) for _ in range(2))
    return q, k, v


def _merged(q, k, v, clen, n_blocks):
    """``_decode_blocks``'s arithmetic over ``n_blocks`` sequence blocks of
    the cache, the calls of the kernel seam counted: (out (B, H, D), calls)."""
    B, _, H, D = q.shape
    n = k.shape[1] // n_blocks
    parts, calls = [], 0
    for b in range(n_blocks):
        c = min(max(clen - b * n, 0), n)
        if c:
            acc, m, l = ops.decode_forward(q, k[:, b * n:(b + 1) * n], v[:, b * n:(b + 1) * n],
                                           c, return_partials=True)
            calls += 1
        else:
            acc, m, l = torch.zeros(B, H, D), torch.full((B, H), -float("inf")), torch.zeros(B, H)
        parts.append((acc, m, l))
    o = tattn.merge_partial_attn(*(torch.stack(t) for t in zip(*parts)))
    return o, calls


@pytest.mark.parametrize("n_blocks,clen,empty", [
    (2, 96, 0), (3, 96, 0), (4, 96, 0),          # every block full
    (4, 60, 1),                                  # block 2 cut mid-tile (12 of 24 rows), one empty
    (4, 40, 2),                                  # block 1 cut, two empty
    (3, 33, 1),                                  # block 0 full, block 1 one row, one empty
])
def test_merged_partials_are_one_decode(n_blocks, clen, empty):
    """The blocks' fp32 partials merged by ``merge_partial_attn`` against one
    ``flash_decode_plain`` call over the whole cache, at 1e-6; an empty block
    calls no kernel, and its ``(0, -inf, 0)`` leaves the merge finite."""
    q, k, v = _decode_case(n_blocks * 100 + clen)
    want = tfd.flash_decode_plain(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), clen)
    got, calls = _merged(q, k, v, clen, n_blocks)
    assert calls == n_blocks - empty
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=MERGE_TOL, atol=MERGE_TOL)


def test_vocab_argmax_takes_the_first_index_on_a_tie(tmp_path):
    """``ctx.vocab_argmax`` over a vocabulary split on 4 gloo ranks: one
    device's ``torch.argmax``, the first index where the largest logit
    repeats within a block and across blocks."""
    script = tmp_path / "argmax.py"
    script.write_text(
        "import sys, torch, torch.distributed as dist\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.parallel import ctx, sharding as shd\n"
        "from repro_torch.configs import registry\n"
        "rank = int(sys.argv[1])\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/store', rank=rank,"
        " world_size=4)\n"
        "mesh = make_mesh((1, 4), ('data', 'model'))\n"
        "cfg = registry.get('olmo-1b').reduced()\n"
        "logits = torch.zeros(5, 1, 16)\n"
        "logits[0, 0, [3, 7, 12]] = 2.0\n"                  # across blocks: index 3
        "logits[1, 0, [9, 10]] = 1.5\n"                     # within block 2: index 9
        "logits[2, 0, 15] = 4.0\n"
        "logits[3] = -1.0\n"                                # all equal: index 0
        "logits[4, 0, [6, 13]] = float('inf')\n"
        "want = torch.argmax(logits, dim=-1)\n"
        "with ctx.model_parallel(mesh, shd.model_layout(cfg, 4)):\n"
        "    got = ctx.vocab_argmax(logits.chunk(4, dim=-1)[rank])\n"
        "assert torch.equal(got, want), (got, want)\n"
        "assert want.flatten().tolist() == [3, 9, 15, 0, 6]\n"
        "dist.destroy_process_group()\n")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], cwd=ROOT, env=_env(),
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        errs = [p.communicate(timeout=RANK_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]


def test_a_serving_step_takes_its_parameters_placed_and_holds_them_weakly(tmp_path):
    """``serve.decode._Layout.params`` on one gloo rank: the local tree of
    leaves placed by ``sharding.serve_specs`` is kept while the same leaves
    come back, and dropped with them; a plain tensor or a leaf placed
    otherwise raises ``ValueError`` (nothing is redistributed)."""
    script = tmp_path / "layout.py"
    script.write_text(
        "import gc, torch, torch.distributed as dist\n"
        "from torch.distributed.tensor import DTensor, Shard\n"
        "from repro_torch import tree\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.serve import decode\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/store', rank=0,"
        " world_size=1)\n"
        "mesh = make_mesh((1, 1), ('data', 'model'))\n"
        "cfg = registry.get('olmo-1b').reduced()\n"
        "lay = decode._Layout(cfg, mesh, False)\n"
        "params = decode.init_params(cfg, mesh, 0, device='cpu')\n"
        "local = lay.params(params)\n"
        "assert lay.params(params) is local\n"
        "assert all(not isinstance(x, DTensor) for x in tree.leaves(local))\n"
        "leaves = tree.leaves(params)\n"
        "for bad in (leaves[0].to_local(),\n"
        "            DTensor.from_local(leaves[0].to_local(), mesh, (Shard(0), Shard(0)))):\n"
        "    try:\n"
        "        lay.params(tree.rebuild(params, [bad] + leaves[1:]))\n"
        "        raise SystemExit('a misplaced leaf was taken')\n"
        "    except ValueError as e:\n"
        "        assert 'parameter leaf 0' in str(e), e\n"
        "    assert lay.held == ([], None)\n"
        "lay.params(params)\n"
        "assert lay.held[1] is not None\n"
        "del params, leaves, local\n"
        "gc.collect()\n"
        "assert lay.held == ([], None), 'the step kept the dropped parameters'\n"
        "dist.destroy_process_group()\n")
    r = subprocess.run([sys.executable, str(script)], cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]


def test_the_serve_worker_imports_neither_jax_nor_the_jax_package():
    """The rank worker runs on the cards too, where the port runs without
    JAX: importing it pulls neither ``jax`` nor ``repro.`` in."""
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_sharded_serve_worker; "
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
