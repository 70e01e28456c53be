"""Sharded serving (``serve.decode.make_prefill_step`` / ``make_serve_step``
with ``mesh=``) for the hybrid (zamba2-7b), ssm (rwkv6-7b) and encdec
(whisper-large-v3) families on 3 or 4 gloo ranks, held to the port's one
device: the prefill's and every decode step's logits within 1e-5, the greedy
tokens exact. Each job prefills prompts shorter than ``max_seq`` and takes 4
decode steps, in fp32 compute at the reduced widths (d 64; zamba2 2 Mamba2
heads and 4 attention heads, rwkv6 4 heads of 16, whisper 4 heads and 8
frames).

The jobs cover each layout of the per-layer states and of the caches
(``sharding.serve_cache_specs``): zamba2 on 2 x 2 with its Mamba2 heads
split (the rank-major ``Segments`` leaves and conv state) and its attention
split by heads, and on (1, 4) with the Mamba2 heads whole and the 4
attention heads split; rwkv6 on 2 x 2 (heads split, rows over data) and on
(1, 3) with ``d_ff`` 96 (heads whole, ``d_ff`` split); whisper on 2 x 2
(self and cross blocks by heads), on (1, 4) with 6 heads and 6 frames (heads
whole, the self cache split by sequence with empty blocks, the cross cache
whole) and with 8 frames (the cross cache split by sequence too); and
zamba2 and rwkv6 at batch 1 under ``seq_shard`` on 2 x 2, writing the last
position as the dry-run's ``long_500k`` cell does (zamba2's attention
cache's sequence over data, its partials merged over data). The zamba2 2 x 2
job is also held to the JAX package's serve steps. The pieces (the
``Segments`` maps, the rank's blocks, every family's ``cache_block``,
``time_mix`` on a rank-local state) are tested alone too.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch import compat, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi
from repro_torch.parallel import sharding as shd

from test_torch_models import reference_mlp_follows_compute_dtype  # noqa: F401
from test_torch_parallel_serve import (ROOT, RANK_TIMEOUT, STEPS, TOL, _cfg, _env, _jax_logits,
                                       _run_ranks)
from torch_sharded_serve_worker import one_device, serve_inputs

WHISPER_6 = {"num_heads": 6, "num_kv_heads": 6}
JOBS = {
    "zamba2-7b": dict(arch="zamba2-7b", mesh=[2, 2], batch=4, prompt=10, max_seq=32),
    "zamba2-7b-tp4": dict(arch="zamba2-7b", mesh=[1, 4], batch=2, prompt=10, max_seq=32),
    "rwkv6-7b": dict(arch="rwkv6-7b", mesh=[2, 2], batch=4, prompt=10, max_seq=32),
    "rwkv6-7b-tp3": dict(arch="rwkv6-7b", mesh=[1, 3], batch=2, prompt=10, max_seq=24,
                         replace={"d_ff": 96}),
    "whisper-large-v3": dict(arch="whisper-large-v3", mesh=[2, 2], batch=4, prompt=10,
                             max_seq=32),
    "whisper-large-v3-tp4": dict(arch="whisper-large-v3", mesh=[1, 4], batch=2, prompt=6,
                                 max_seq=32, replace={**WHISPER_6, "frontend_len": 6}),
    "whisper-large-v3-tp4-cross": dict(arch="whisper-large-v3", mesh=[1, 4], batch=2,
                                       prompt=6, max_seq=32, replace=WHISPER_6),
    "zamba2-7b-long": dict(arch="zamba2-7b", mesh=[2, 2], batch=1, prompt=28, max_seq=32,
                           seq_shard=True),
    "rwkv6-7b-long": dict(arch="rwkv6-7b", mesh=[2, 2], batch=1, prompt=28, max_seq=32,
                          seq_shard=True),
}
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


def _filled(job, first):
    """Of the decode steps (step s writes position prompt + s), those after
    which a block starting at ``first`` holds a filled row."""
    return sum(job["prompt"] + s + 1 > first for s in range(STEPS))


@EVERY_JOB
def test_each_job_serves_the_state_and_cache_layout_its_name_says(served, name):
    """Each rank holds its block of every cache leaf: a Mamba2 ``ssm`` state
    and an RWKV6 ``S`` by heads where they split, a Mamba2 ``conv`` state of
    the rank's ``Segments`` channels (x by heads, B and C whole), an
    RWKV6 ``x_att`` / ``x_cmix`` whole, the K/V stacks by kv heads or by
    sequence; its rows over data unless ``seq_shard``; and a block the filled
    length has not reached calls no decode kernel."""
    name, out, _, _ = served(name)
    job, cfg = JOBS[name], _cfg(JOBS[name])
    lay, ranks = out["layout"], out["ranks"]
    data, tp = job["mesh"]
    rows = job["batch"] if job.get("seq_shard") else job["batch"] // data
    assert {r["block"]["rows"][1] for r in ranks} == {rows}
    for r in ranks:
        shapes = r["cache_local_shapes"]
        states = {k.rsplit("/", 1)[1]: v for k, v in shapes.items() if "/" in k}
        kv = r["cache_local_shape"]
        if cfg.family == "hybrid":
            H = 2 // tp if lay["ssm_heads"] else 2
            assert lay["ssm_heads"] == (tp == 2)
            assert states["ssm"] == [rows, H, 64, cfg.ssm_state]
            assert states["conv"] == [rows, cfg.ssm_conv - 1, 64 * H + 2 * cfg.ssm_state]
        if cfg.family == "ssm":
            H = 4 // tp if lay["ssm_heads"] else 4
            assert lay["ssm_heads"] == (tp == 2) and lay["d_ff"]
            assert states["S"] == [rows, H, 16, 16]
            assert states["x_att"] == states["x_cmix"] == [rows, cfg.d_model]
            assert kv is None and r["decode_calls"] == 0
            continue
        n_layers = cfg.hybrid_groups if cfg.family == "hybrid" else cfg.dec_layers
        seq_axes = r["block"]["seq_axes"]
        heads = cfg.num_kv_heads // tp if lay["kv_heads"] else cfg.num_kv_heads
        n_blocks = int(np.prod([job["mesh"][["data", "model"].index(a)] for a in seq_axes]))
        assert kv == [n_layers, rows, job["max_seq"] // n_blocks, heads, 16]
        filled = _filled(job, r["block"]["seq"][0]) if seq_axes else 0
        assert r["decode_blocks"] == (n_layers * STEPS if seq_axes else 0)
        if cfg.family == "hybrid":
            assert r["partials_calls"] == n_layers * filled
            assert r["decode_calls"] == n_layers * (filled if seq_axes else STEPS)
        if cfg.family == "encdec":
            cross = r["block"]["cross"]
            cross_blocks = int(np.prod([tp for _ in cross["seq_axes"]]))
            assert shapes["cross_k"] == [n_layers, rows, cfg.frontend_len // cross_blocks,
                                         kv[3], 16]
            # the self blocks' partials where the sequence splits, the cross
            # cache's one call a layer a step (partials where it splits too)
            assert r["partials_calls"] == n_layers * (
                filled + (STEPS if cross["seq_axes"] else 0))
            assert r["decode_calls"] == n_layers * (STEPS + (filled if seq_axes else STEPS))
    if name == "whisper-large-v3-tp4":
        assert not lay["heads"] and not ranks[0]["block"]["cross"]["seq_axes"]
        assert any(r["decode_blocks"] and not r["partials_calls"] for r in ranks)  # empty
    if name == "whisper-large-v3-tp4-cross":
        assert ranks[0]["block"]["cross"]["seq_axes"] == ["model"]
    if name == "zamba2-7b-long":
        assert all(r["block"]["seq_axes"] == ["data"] for r in ranks)
    if name == "zamba2-7b-tp4":
        assert lay["heads"] and not lay["ssm_heads"]


def test_zamba2_sharded_serving_matches_the_jax_package(served, monkeypatch,
                                                         reference_mlp_follows_compute_dtype):
    """zamba2-7b on 2 x 2, its Mamba2 heads split, against the JAX package's
    ``make_prefill_step`` / ``make_serve_step`` on one device from the same
    weights: logits within 1e-5, tokens exact."""
    name, out, _, _ = served("zamba2-7b")
    job = JOBS[name]
    cfg = _cfg(job)
    cfg_j = dataclasses.replace(jregistry.get(job["arch"]).reduced(), compute_dtype="float32")
    params = compat.params_to_jax(cfg, tapi.init(cfg, 0, device="cpu"))
    toks, logits = _jax_logits(monkeypatch, cfg_j, jax.tree.map(jnp.asarray, params),
                               serve_inputs(cfg, job["batch"], job["prompt"]), job["max_seq"])
    np.testing.assert_array_equal(np.asarray(out["tokens"]), toks)
    assert len(logits) == len(out["logits"])
    for got, want in zip(out["logits"], logits):
        np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

class FakeMesh:
    """Duck-typed mesh of one rank's coordinates: the rules read ``.shape``,
    ``.axis_names`` and ``get_local_rank``."""

    def __init__(self, rank=None, **axes):
        self.shape, self.axis_names = dict(axes), tuple(axes)
        self.rank = rank or {}

    def get_local_rank(self, axis):
        return self.rank.get(axis, 0)


SEGMENTS = [shd.Segments((8, 8, 3, 3, 4), (True, True, False, False, True)),
            shd.Segments((12, 2, 2), (True, False, False))]


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("seg", range(len(SEGMENTS)))
def test_the_segments_maps_are_inverse(seg, tp):
    """``to_one_device`` undoes ``to_rank_major``, along either dim; at tp 1
    both are the identity; the rank-major layout is the ranks' ``take``
    blocks in rank order, ``tp * block_size(tp)`` wide."""
    s = SEGMENTS[seg]
    width = sum(s.sizes)
    x = torch.randn(5, width, generator=torch.Generator().manual_seed(tp))
    for dim, t in ((1, x), (0, x.T.contiguous())):
        major = s.to_rank_major(t, dim, tp)
        assert major.shape[dim] == tp * s.block_size(tp)
        assert torch.equal(s.to_one_device(major, dim, tp), t)
        for r, block in enumerate(major.chunk(tp, dim=dim)):
            assert torch.equal(block, s.take(t, dim, tp, r))
        if tp == 1:
            assert major is t and s.to_one_device(t, dim, tp) is t


@pytest.mark.parametrize("rank", range(2))
def test_a_ranks_block_of_in_proj_and_conv_is_segments_take(rank):
    """On a (2, 2) mesh, zamba2's reduced leaves in the serving layout: the
    rank's block of the rank-major ``in_proj`` / ``conv_w`` / ``conv_b``
    (what ``shard_params`` keeps) is ``Segments.take`` of the whole leaf, the
    conv state's rank-major width is ``tp`` blocks of the rank's channels,
    and no other leaf changes shape."""
    cfg = tregistry.get("zamba2-7b").reduced()
    mesh = FakeMesh(rank={"model": rank}, data=2, model=2)
    whole = tapi.init(cfg, 0, device="cpu")
    major = shd.rank_major(cfg, whole, mesh)
    specs = tree.leaves(shd.serve_specs(cfg, whole, mesh), is_leaf=shd.is_spec)
    layout = shd.compute_layout(cfg, whole, mesh)
    seen = 0
    for (path, w), m, spec, (cspec, _) in zip(tree.leaves_with_paths(whole), tree.leaves(major),
                                               specs, layout):
        seg = [(d, e) for d, e in enumerate(cspec) if isinstance(e, shd.Segments)]
        if not seg:
            assert m.shape == w.shape, path
            continue
        (dim, e), = seg
        assert spec[dim] == "model" and path[-1] in ("w", "conv_w", "conv_b")
        first, n = shd.entry_block(mesh, spec[dim], m.shape[dim])
        assert torch.equal(m.narrow(dim, first, n), e.take(w, dim, 2, rank))
        seen += 1
    assert seen == 3 * (cfg.hybrid_prologue + cfg.hybrid_groups * cfg.hybrid_mamba_per_group)
    one = tapi.init_cache(cfg, 4, 32, device="meta")
    major = shd.rank_major_cache(cfg, one, mesh)
    specs = shd.serve_cache_specs(cfg, mesh, batch=4, max_seq=32)
    d_inner, n = cfg.ssm_expand * cfg.d_model, 0
    for (path, x), m, spec in zip(tree.leaves_with_paths({k: v for k, v in one.items()
                                                          if k != "idx"}),
                                  tree.leaves({k: v for k, v in major.items() if k != "idx"}),
                                  specs):
        if path[-1] == "conv":
            assert spec == ("data", None, "model") and m.shape[:2] == x.shape[:2]
            assert m.shape[2] == 2 * (d_inner // 2 + 2 * cfg.ssm_state)
            n += 1
        else:
            assert m.shape == x.shape
    assert n == cfg.hybrid_prologue + cfg.hybrid_groups * cfg.hybrid_mamba_per_group


@pytest.mark.parametrize("tp", [4, 16])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-7b", "whisper-large-v3"])
def test_cache_block_gives_every_familys_rows_and_blocks(arch, tp):
    """Full-width ``cache_block`` on a fake (2, tp) mesh, each rank's
    coordinates: the batch rows over data for every family (under
    ``seq_shard`` the whole batch), the K/V stack's kv heads or sequence,
    and whisper's two blocks. At tp 16 whisper's 20 heads do not split: its
    self cache splits by sequence, its 1500-frame cross cache (1500 % 16)
    stays whole on every model rank; at tp 4 both split by heads."""
    cfg = tregistry.get(arch)
    batch, max_seq = 8, 4096
    blocks = {}
    for d in range(2):
        for m in range(tp):
            mesh = FakeMesh(rank={"data": d, "model": m}, data=2, model=tp)
            b = shd.cache_block(cfg, mesh, batch=batch, max_seq=max_seq)
            assert b.rows == (d * 4, 4) and b.rows_split
            blocks[d, m] = b
            long = shd.cache_block(cfg, mesh, batch=1, max_seq=max_seq, seq_shard=True)
            assert long.rows == (0, 1) and not long.rows_split
            if cfg.family == "hybrid":       # 32 kv heads over tp; the sequence over data
                assert long.heads == (m * 32 // tp, 32 // tp)
                assert long.seq == (d * max_seq // 2, max_seq // 2)
                assert long.seq_axes == ("data",)
    b = blocks[1, tp - 1]
    if cfg.family == "ssm":
        assert b.seq_axes == () and b.cross is None and b.spec[2:] == (None,) * 3
    elif cfg.family == "hybrid":
        assert b.heads == ((tp - 1) * 32 // tp, 32 // tp) and b.seq == (0, max_seq)
    else:
        assert b.cross is not None and b.cross.rows == b.rows
        if tp == 4:
            assert b.heads == b.cross.heads == (15, 5) and not b.seq_axes
            assert b.cross.seq == (0, 1500)
        else:
            assert b.heads == (0, 20) and b.seq_axes == ("model",)
            assert b.seq == (15 * max_seq // 16, max_seq // 16)
            assert b.cross.heads == (0, 20) and b.cross.seq == (0, 1500)
            assert b.cross.seq_axes == () and b.cross.spec[2:4] == (None, None)


def test_time_mix_takes_a_rank_local_state_as_it_is(tmp_path):
    """RWKV6's ``time_mix`` on 2 gloo ranks with its heads split: handed a
    state of every head it takes the rank's heads of it; handed the rank's
    heads alone (a sharded prefill's or decode step's state) it takes them
    as they are. Both give one device's output and the rank's heads of one
    device's new state, for one token and for a chunked sequence."""
    script = tmp_path / "tmix.py"
    script.write_text(
        "import sys, torch, torch.distributed as dist\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "from repro_torch.models import rwkv\n"
        "from repro_torch.parallel import ctx, sharding as shd\n"
        "rank = int(sys.argv[1])\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/store', rank=rank,"
        " world_size=2)\n"
        "mesh = make_mesh((1, 2), ('data', 'model'))\n"
        "cfg = registry.get('rwkv6-7b').reduced()\n"
        "g = torch.Generator().manual_seed(0)\n"
        "p = rwkv.rwkv_init(g, cfg)['tmix']\n"
        "specs = [s for s, _ in shd.compute_layout(cfg, {'blocks': [{'block': {'tmix': p}}]},"
        " mesh)]\n"
        "from repro_torch import tree\n"
        "local = [x.narrow(s.index('model'), rank * x.shape[s.index('model')] // 2,"
        " x.shape[s.index('model')] // 2) if 'model' in s else x"
        " for x, s in zip(tree.leaves(p), specs)]\n"
        "lp = tree.rebuild(p, local)\n"
        "for S in (1, 70):\n"
        "    x = torch.randn(2, S, cfg.d_model, generator=g)\n"
        "    S0 = torch.randn(2, 4, 16, 16, generator=g)\n"
        "    xp = torch.randn(2, cfg.d_model, generator=g)\n"
        "    y, S1, _ = rwkv.time_mix(p, x, cfg, S0=S0, x_prev=xp)\n"
        "    mine = S1[:, 2 * rank:2 * rank + 2]\n"
        "    with ctx.model_parallel(mesh, shd.model_layout(cfg, 2)):\n"
        "        for state in (S0, S0[:, 2 * rank:2 * rank + 2]):\n"
        "            ys, Ss, _ = rwkv.time_mix(lp, x, cfg, S0=state, x_prev=xp)\n"
        "            torch.testing.assert_close(ys, y, rtol=1e-5, atol=1e-5)\n"
        "            torch.testing.assert_close(Ss, mine, rtol=1e-5, atol=1e-5)\n"
        "dist.destroy_process_group()\n")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], cwd=ROOT, env=_env(),
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=RANK_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
