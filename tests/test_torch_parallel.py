"""The port's sharding half against the JAX package's: the meta-device init
against ``jax.eval_shape``, the sharding rules, the batch / data / cache specs
and the per-cell plans on both production meshes at full width (the
reference's ``FakeMesh`` stands in for 256 and 512 devices), DTensor
placements on a fake process group of 512, the activation context, the
compute layout over ``model``, and sharded training on 3 or 4 gloo ranks
(2 x 2, 1 x 4 and 1 x 3 meshes, the partitioned route) held to the
single-device port run,
with an elastic checkpoint restore and the launcher under
``torch.distributed.run``. The training jobs and their checks live in
``tests/torch_sharded_train_checks.py``; this file runs the jobs with the
residual whole, ``tests/test_torch_parallel_seq.py`` those split by
sequence.
"""
import dataclasses
import re
import signal
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jregistry
from repro.launch import specs as jspecs
from repro.models import api as japi
from repro.parallel import sharding as jshd
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import JAX_STACKED_DIMS
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as tshd
from torch_sharded_train_checks import (  # noqa: F401  (the checks run here too)
    JOBS, RANK_TIMEOUT, ROOT, SP, TOL, _env, _run_ranks, _single_device, run_job,
    test_sharded_run_checks_its_own_invariants,
    test_sharded_training_matches_the_single_device_run,
    test_the_residual_is_split_by_sequence_where_tp_divides_it)

ARCHS = list(tregistry.ARCHS)
REF_BUDGET = 14.5e9          # the reference's HBM_BUDGET, for the plan parity


class FakeMesh:
    """Duck-typed mesh: the rules read .shape and .axis_names; the reference's
    plan_cell also reads .size and .devices.shape."""
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = int(np.prod(list(axes.values())))
        self.devices = np.empty(tuple(axes.values()), dtype=object)


MESH = FakeMesh(data=16, model=16)
MESH_POD = FakeMesh(pod=2, data=16, model=16)
MESHES = pytest.mark.parametrize("mesh", [MESH, MESH_POD], ids=["16x16", "2x16x16"])


def _axis_product(mesh, entry):
    axes = entry if isinstance(entry, tuple) else (entry,)
    prod = 1
    for a in axes:
        prod *= mesh.shape[a]
    return prod


def _jax_struct(arch):
    cfg = jregistry.get(arch)
    return cfg, jax.eval_shape(lambda: japi.init(cfg, jax.random.PRNGKey(0)))


def _ref_by_port_path(jtree, is_leaf=None):
    """{port path: reference leaf, leading stacking dims}: the reference's tree
    read with the port's paths (the list positions left out)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree, is_leaf=is_leaf)[0]:
        keys = tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[keys] = (leaf, JAX_STACKED_DIMS.get(keys[0], 0))
    return out


def _port_key(path):
    return tuple(str(p) for p in path if not isinstance(p, int))


# ---------------------------------------------------------------------------
# meta init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_matches_eval_shape(arch):
    """``api.init(cfg, device="meta")`` holds the reference's full-width shapes
    and dtypes leaf by leaf, after the stacked layers are unstacked."""
    _, struct = _jax_struct(arch)
    want = {}
    for keys, (leaf, stack) in _ref_by_port_path(struct).items():
        for idx in np.ndindex(*leaf.shape[:stack]):
            want[(keys[0],) + idx + keys[1:]] = (tuple(leaf.shape[stack:]), str(leaf.dtype))
    got = {tuple(str(p) for p in path): (tuple(t.shape), str(t.dtype)[6:])
           for path, t in tree.leaves_with_paths(tapi.init(tregistry.get(arch), device="meta"))}
    assert got == {tuple(str(p) for p in k): v for k, v in want.items()}
    assert all(t.device.type == "meta"
               for t in tree.leaves(tapi.init(tregistry.get(arch), device="meta")))


def test_meta_init_leaves_the_seeded_build_alone():
    cfg = tregistry.get("olmo-1b").reduced()
    a, b = tapi.init(cfg, 0, device="cpu"), tapi.init(cfg, 0, device="cpu")
    meta = tapi.init(cfg, device="meta")
    for x, y, m in zip(tree.leaves(a), tree.leaves(b), tree.leaves(meta)):
        assert torch.equal(x, y)
        assert (x.shape, x.dtype) == (m.shape, m.dtype)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

@MESHES
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh):
    """Each layer's spec is the reference's for the stacked leaf without its
    stacking ``None``s; every other leaf's is the reference's."""
    jcfg, struct = _jax_struct(arch)
    ref = _ref_by_port_path(jshd.param_specs(jcfg, struct, mesh),
                            is_leaf=lambda x: isinstance(x, P))
    cfg = tregistry.get(arch)
    specs = tshd.param_specs(cfg, tapi.init(cfg, device="meta"), mesh)
    seen = set()
    for path, spec in tree.leaves_with_paths(specs, is_leaf=tshd.is_spec):
        key = _port_key(path)
        want, stack = ref[key]
        stack = 0 if key[0] == "shared_attn" else stack
        assert tuple(want)[:stack] == (None,) * stack, (key, want)
        assert spec == tuple(want)[stack:], (key, spec, want)
        seen.add(key)
    assert seen == set(ref)


@MESHES
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divide_full_configs(arch, mesh):
    """Mirror of tests/test_parallel.py::test_param_specs_divide_full_configs."""
    cfg = tregistry.get(arch)
    params = tapi.init(cfg, device="meta")
    specs = tshd.param_specs(cfg, params, mesh)
    for (path, leaf), spec in zip(tree.leaves_with_paths(params),
                                  tree.leaves(specs, is_leaf=tshd.is_spec)):
        assert len(spec) <= leaf.dim()
        for i, entry in enumerate(spec):
            if entry is not None:
                assert leaf.shape[i] % _axis_product(mesh, entry) == 0, (path, i, entry)


@pytest.mark.parametrize("arch", ["grok-1-314b", "command-r-plus-104b", "dbrx-132b"])
def test_params_are_fsdp_sharded_not_replicated(arch):
    """Mirror of tests/test_parallel.py: >= 90 % of the parameter bytes shard
    over the fsdp axes."""
    cfg = tregistry.get(arch)
    params = tapi.init(cfg, device="meta")
    specs = tshd.param_specs(cfg, params, MESH)
    tot = sharded = 0
    for leaf, spec in zip(tree.leaves(params), tree.leaves(specs, is_leaf=tshd.is_spec)):
        tot += leaf.numel()
        flat = [a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))]
        if "data" in flat:
            sharded += leaf.numel()
    assert sharded / tot > 0.9, f"{arch}: only {sharded / tot:.0%} FSDP-sharded"


@settings(max_examples=80, deadline=None)
@given(dim=st.integers(1, 10_000), ax=st.sampled_from(
    [("data",), ("model",), ("data", "model"), None]))
def test_sanitize_spec_always_valid(dim, ax):
    spec = (ax if ax is None or len(ax) > 1 else ax[0],)
    out = tshd.sanitize_spec(spec, (dim,), MESH)
    assert out == tuple(jshd.sanitize_spec(P(*spec), (dim,), MESH))
    if out[0] is not None:
        assert dim % _axis_product(MESH, out[0]) == 0


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    assert tshd.placements(("data", "model"), MESH) == (Shard(0), Shard(1))
    assert tshd.placements(("model", None, "data"), MESH) == (Shard(2), Shard(0))
    assert tshd.placements((None,), MESH) == (Replicate(), Replicate())
    assert tshd.placements(((("pod", "data")), None, "model"), MESH_POD) == (
        Shard(0), Shard(0), Shard(2))
    assert tshd.placements((("data", "model"),), MESH) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="axis order"):
        tshd.placements((("model", "data"),), MESH)
    with pytest.raises(ValueError, match="twice"):
        tshd.placements(("data", "data"), MESH)
    with pytest.raises(ValueError, match="lacks"):
        tshd.placements(("pod",), MESH)


@MESHES
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_data_and_cache_specs_match_the_reference(arch, mesh):
    jcfg, cfg = jregistry.get(arch), tregistry.get(arch)
    assert tshd.batch_spec(mesh) == tuple(jshd.batch_spec(mesh))
    for kind in ("train", "prefill", "decode"):
        want = jshd.data_specs(jcfg, kind, mesh, batch=8)
        got = tshd.data_specs(cfg, kind, mesh, batch=8)
        assert got == {k: tuple(v) for k, v in want.items()}
    for seq_shard in (False, True):
        want = jshd.cache_specs(jcfg, mesh, batch=8, seq_shard=seq_shard)
        got = tshd.cache_specs(cfg, mesh, batch=8, seq_shard=seq_shard)
        ref = _ref_by_port_path(want, is_leaf=lambda x: isinstance(x, P))
        assert tuple(ref.pop(("idx",))[0]) == ()          # a host int in the port
        cache = tapi.init_cache(cfg, 2, 16, device="meta")
        paths = [p for p, _ in tree.leaves_with_paths({k: v for k, v in cache.items()
                                                       if k != "idx"})]
        specs = tree.leaves_with_paths(got, is_leaf=tshd.is_spec)
        assert [p for p, _ in specs] == paths             # one spec a cache tensor
        for path, spec in specs:
            r, _ = ref[_port_key(path)]
            stack = sum(isinstance(p, int) for p in path)
            assert tuple(r) == (None,) * stack + spec, (path, spec, r)


# ---------------------------------------------------------------------------
# plans and cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perf", ["0", "1"], ids=["baseline", "REPRO_PERF"])
@MESHES
def test_plan_cell_matches_the_reference_on_every_cell(mesh, perf, monkeypatch):
    """All 40 cells, at the reference's budget (the port's is the H100's)."""
    monkeypatch.setenv("REPRO_PERF", perf)
    monkeypatch.setattr(tspecs, "HBM_BUDGET", REF_BUDGET)
    assert jspecs.HBM_BUDGET == REF_BUDGET
    cells = list(tregistry.cells())
    assert len(cells) == 40
    for cfg, shape, _, _ in cells:
        want = dataclasses.asdict(jspecs.plan_cell(jregistry.get(cfg.name), shape, mesh))
        got = dataclasses.asdict(tspecs.plan_cell(cfg, shape, mesh))
        assert got == want, (cfg.name, shape.name)
    assert tspecs.PERF_OVERRIDES == jspecs.PERF_OVERRIDES
    label = "x".join(map(str, mesh.shape.values()))
    assert any((cfg.name, shape.name, label) in tspecs.PERF_OVERRIDES for cfg, shape, _, _ in cells)


def test_hbm_budget_is_the_h100s():
    assert 70e9 < tspecs.HBM_BUDGET < 80e9


@pytest.mark.parametrize("arch", ["olmo-1b", "dbrx-132b", "pixtral-12b", "zamba2-7b",
                                  "rwkv6-7b", "whisper-large-v3"])
def test_build_cell_gives_meta_args_and_placements(arch):
    """Every kind of cell: the reference's keys, meta-tensor args at the
    cell's shapes and one placements tuple an argument tensor."""
    cfg = tregistry.get(arch)
    for shape in tregistry.SHAPES.values():
        cell = tspecs.build_cell(cfg, shape, MESH)
        assert set(cell) == {"fn", "args", "in_shardings", "donate", "plan", "meta"}
        assert cell["meta"]["kind"] == shape.kind and callable(cell["fn"])
        # args and in_shardings are tuples of one entry an argument
        args = [x for x in tree.leaves(cell["args"]) if isinstance(x, torch.Tensor)]
        shards = [pl for sh in cell["in_shardings"]
                  for pl in tree.leaves(sh, is_leaf=tshd.is_spec)]
        assert all(x.device.type == "meta" for x in args)
        assert len(args) == len(shards), (arch, shape.name)
        for x, pl in zip(args, shards):
            assert len(pl) == 2
            for dim in {p.dim for p in pl if hasattr(p, "dim")}:
                prod = np.prod([MESH.shape[a] for a, p in zip(MESH.axis_names, pl)
                                if getattr(p, "dim", None) == dim])
                assert x.shape[dim] % prod == 0, (arch, shape.name, x.shape, pl)
        if shape.kind == "train":
            state, batch = cell["args"]
            assert batch["tokens"].shape == (shape.global_batch, shape.seq_len - (
                cfg.frontend_len if cfg.family == "vlm" else 0))
            assert state.opt_state.m["emb"]["table"].dtype == getattr(
                torch, cell["plan"].opt_dtype)


PLACEMENTS_SCRIPT = textwrap.dedent("""
    import math, sys
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    mesh = lmesh.make_production_mesh(multi_pod=True)
    assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("pod", "data", "model")
    try:
        lmesh.make_production_mesh()
        raise AssertionError("a 16x16 mesh on 512 ranks was made")
    except lmesh.MeshSizeError:
        pass
    sizes = shd.axis_sizes(mesh)
    n = 0
    for arch in sys.argv[1:]:
        cfg = registry.get(arch)
        params = api.init(cfg, device="meta")
        specs = tree.leaves(shd.param_specs(cfg, params, mesh), is_leaf=shd.is_spec)
        for p, spec in zip(tree.leaves(params), specs):
            d = distribute_tensor(p, mesh, shd.placements(spec, mesh), src_data_rank=None)
            want = list(p.shape)
            for i, e in enumerate(spec):
                if e is not None:
                    want[i] //= math.prod(sizes[a] for a in (e if isinstance(e, tuple) else (e,)))
            assert list(d.to_local().shape) == want, (arch, p.shape, spec, d.to_local().shape)
            n += 1
    print("PLACED", n)
""")


def test_local_shapes_on_a_fake_group_of_512():
    """A DTensor's local shape on the (2, 16, 16) mesh is the global shape
    divided by each entry's axis product, for every leaf of one arch a family."""
    archs = ["llama3-8b", "dbrx-132b", "pixtral-12b", "zamba2-7b", "rwkv6-7b",
             "whisper-large-v3"]
    r = subprocess.run([sys.executable, "-c", PLACEMENTS_SCRIPT, *archs], cwd=ROOT,
                       env=_env(), capture_output=True, text=True, timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split("PLACED")[1]) > 1000


# ---------------------------------------------------------------------------
# activation context
# ---------------------------------------------------------------------------

def test_constrain_outside_a_scope_and_on_plain_tensors_is_the_identity():
    x = torch.ones(2, 3, 4)
    assert pctx.current() is None and pctx.constrain(x) is x
    with pctx.activation_sharding(residual=("data", None, None)):
        assert pctx.current().get("residual") == ("data", None, None)
        assert pctx.constrain(x) is x                       # a plain tensor: a rank's rows
        assert pctx.constrain(x, "kv_collect") is x         # no entry for the kind
        with pctx.activation_sharding(moe_tokens=("data", None, None, None)):
            assert pctx.current().get("residual") is None
        assert pctx.current().get("residual") == ("data", None, None)
        seen = []
        t = threading.Thread(target=lambda: seen.append(pctx.current()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [None]          # the scope is the thread's
    assert pctx.current() is None


def test_data_parallel_statistics_outside_a_scope():
    x = torch.arange(4.0)
    assert pctx.data_mesh() is None and pctx.data_size() == 1
    assert pctx.data_sum(x) is x


def test_model_parallel_operators_outside_a_scope_are_the_identity():
    """Outside ``model_parallel`` the operators return their input and launch
    nothing, there is no layout, and the layers take their one-device paths."""
    x = torch.arange(6.0).reshape(2, 3)
    assert pctx.model_group() is None and pctx.model_index() == 0
    assert pctx.model_size() == 1 and pctx.layout() is None
    assert pctx.to_model(x) is x and pctx.from_model(x) is x
    assert pctx.gather_from_model(x, -1) is x
    assert not pctx.seq_parallel()
    for op in (pctx.seq_rows, pctx.seq_gather_f32, pctx.seq_columns_to_rows,
               pctx.seq_rows_of_sum):
        assert op(x) is x
    p = {"w": torch.ones(3, 4), "b": torch.ones(4)}
    assert torch.equal(tlayers.dense_split(p, x, dtype=torch.float32),
                       tlayers.dense(p, x, dtype=torch.float32))


SEQ_OPS_SCRIPT = textwrap.dedent("""
    import sys
    import torch, torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    from repro_torch.parallel import ctx as pctx, sharding as shd

    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
    mesh = make_mesh((1, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    B, S, N = 2, 6, 4
    x, y, up = (torch.randn(B, S, N, generator=g) for _ in range(3))
    ups = torch.randn(2, B, S, N, generator=g)       # each rank's own upstream gradient
    rows, cols = slice(rank * 3, rank * 3 + 3), slice(rank * 2, rank * 2 + 2)

    def grad(fn, t, upstream):
        t = t.clone().requires_grad_(True)
        out = fn(t)
        out.backward(upstream)
        return out.detach(), t.grad

    lay = shd.model_layout(type("C", (), dict(num_heads=4, num_kv_heads=4, d_ff=8, d_model=N,
                                              vocab_size=8, num_experts=0, family="dense"))(), 2)
    with pctx.model_parallel(mesh, lay, seq=True):
        assert pctx.seq_parallel()
        out, gx = grad(pctx.seq_rows, x, up[:, rows])
        assert torch.equal(out, x[:, rows]) and torch.equal(gx, up)     # rows; gathered back
        out, gx = grad(pctx.seq_gather_f32, x[:, rows].bfloat16(), ups[rank])
        assert out.dtype == torch.float32 and torch.equal(out, x.bfloat16().float())
        assert torch.equal(gx, (ups[0] + ups[1])[:, rows].bfloat16())  # fp32 sum, rounded once
        out, gy = grad(pctx.seq_columns_to_rows, y[..., cols], up[:, rows])
        assert torch.equal(out, y[:, rows]) and torch.equal(gy, up[..., cols])
        out, gx = grad(pctx.seq_rows_of_sum, torch.where(torch.arange(N) // 2 == rank, x, 0),
                       up[:, rows])
        assert torch.equal(out, x[:, rows]) and torch.equal(gx, up)
        w = torch.randn(N, N, generator=g)
        out, gx = grad(lambda t: layers.dense_columns({"w": w[:, cols]}, t, dtype=torch.float32),
                       x, up[:, rows])
        assert torch.allclose(out, (x @ w)[:, rows], atol=1e-6)        # rows of whole columns
        assert torch.allclose(gx, up @ w.T, atol=1e-5)                 # whole, summed over ranks
    assert not pctx.seq_parallel()
    print("OK")
""")


def test_sequence_parallel_operators_on_two_gloo_ranks(tmp_path):
    """``ctx.seq_rows``, ``seq_gather_f32``, ``seq_columns_to_rows``,
    ``seq_rows_of_sum`` and ``layers.dense_columns`` inside ``model_parallel(...,
    seq=True)`` on a (1, 2) mesh, forward and backward, against the whole
    tensors each computes from: rows of 6 positions, 2 columns of 4 a rank."""
    procs = [subprocess.Popen([sys.executable, "-c", SEQ_OPS_SCRIPT, str(r),
                               str(tmp_path / "store")], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "OK", err[-3000:]


@pytest.mark.parametrize("heads,tp,rank,want", [
    ((16, 2), 16, 9, (1, 1, None)),          # qwen2.5-3b: one q head a rank
    ((32, 8), 16, 3, (1, 1, None)),          # pixtral: q heads 6, 7 share kv head 1
    ((48, 8), 16, 2, (1, 1, None)),          # dbrx / grok: q heads 6-8
    ((12, 4), 3, 1, (1, 2, None)),           # q heads 4-7: kv 1, 1, 2, 2
    ((12, 4), 3, 0, (0, 2, [0, 0, 0, 1])),   # q heads 0-3: kv 0, 0, 0, 1, one a q head
])
def test_kv_heads_of_a_ranks_q_heads(heads, tp, rank, want):
    from repro_torch.models.attention import _kv_heads_of_q_heads
    cfg = dataclasses.replace(tregistry.get("qwen2.5-3b"), num_heads=heads[0],
                              num_kv_heads=heads[1])
    assert _kv_heads_of_q_heads(cfg, heads[0] // tp, rank) == want


# the compute layout over model at full width on the 16 x 16 mesh: (leaf of the
# first block, spec, gradient) by the module docstring's cases
LAYOUT_CASES = {
    # MHA, 16 heads: every projection by heads, wo and wd by output columns
    "olmo-1b": {("attn", "wq", "w"): ((None, "model"), "shard"),
                ("attn", "wk", "w"): ((None, "model"), "shard"),
                ("attn", "wo", "w"): ((None, "model"), "shard"),
                ("mlp", "wd", "w"): ((None, "model"), "shard")},
    # GQA, 2 kv heads over 16: wk / wv (and their biases) gathered, partial sums
    "qwen2.5-3b": {("attn", "wq", "b"): (("model",), "shard"),
                   ("attn", "wk", "w"): ((None, None), "sum"),
                   ("attn", "wv", "b"): ((None,), "sum"),
                   ("attn", "wo", "w"): ((None, "model"), "shard")},
    # 36 heads over 16: the whole attention replicated; the MLP split
    "minicpm-2b": {("attn", "wq", "w"): ((None, None), "same"),
                   ("attn", "wo", "w"): ((None, None), "same"),
                   ("mlp", "wg", "w"): ((None, "model"), "shard"),
                   ("mlp", "wd", "w"): ((None, "model"), "shard")},
    # 16 experts over 16: EP; the router replicated
    "dbrx-132b": {("moe", "wg"): (("model", None, None), "shard"),
                  ("moe", "wd"): (("model", None, None), "shard"),
                  ("moe", "router"): ((None, None), "same")},
    # 8 experts over 16: TP within the experts
    "grok-1-314b": {("moe", "wu"): ((None, None, "model"), "shard"),
                    ("moe", "wd"): ((None, None, "model"), "shard")},
}


@pytest.mark.parametrize("arch", list(LAYOUT_CASES))
def test_compute_layout_cases_at_full_width(arch):
    cfg = tregistry.get(arch)
    params = tapi.init(cfg, device="meta")
    layout = dict(zip([_port_key(p) for p, _ in tree.leaves_with_paths(params)],
                      tshd.compute_layout(cfg, params, MESH)))
    for leaf, want in LAYOUT_CASES[arch].items():
        assert layout[("blocks",) + leaf] == want, (arch, leaf)
    # the vocabulary: by rows where tp divides it (minicpm's 122753 is odd)
    want = ((None, None), "same") if arch == "minicpm-2b" else (("model", None), "shard")
    assert layout[("emb", "table")] == want
    assert all(g in ("shard", "sum", "same") for _, g in layout.values())


# tp values the launcher accepts that divide some of a model's dims and not
# others: (arch, tp, leaf of the first block, want)
ODD_TP_CASES = [
    # 48 q heads over 6 split, 8 kv heads do not: wk / wv whole, and each
    # rank's gradient of them a partial sum, though sanitize_spec leaves them
    # unsharded at rest (1024 % 6)
    ("dbrx-132b", 6, ("attn", "wk", "w"), ((None, None), "sum")),
    ("dbrx-132b", 6, ("attn", "wv", "w"), ((None, None), "sum")),
    ("dbrx-132b", 6, ("attn", "wq", "w"), ((None, "model"), "shard")),
    ("grok-1-314b", 3, ("attn", "wk", "w"), ((None, None), "sum")),
    # d_ff 5760 over 5 splits, d_model 2304 does not: wd whole on every rank
    ("minicpm-2b", 5, ("mlp", "wg", "w"), ((None, "model"), "shard")),
    ("minicpm-2b", 5, ("mlp", "wd", "w"), ((None, None), "same")),
    ("minicpm-2b", 5, ("attn", "wq", "w"), ((None, None), "same")),
    # 16 experts over 7: TP within them (d_ff 10752 splits); d_model 6144 does
    # not, so every rank computes all of wd's columns
    ("dbrx-132b", 7, ("moe", "wg"), ((None, None, "model"), "shard")),
    ("dbrx-132b", 7, ("moe", "wd"), ((None, None, None), "same")),
    # 8 experts and d_ff 32768 over 3: the experts whole on every rank
    ("grok-1-314b", 3, ("moe", "wg"), ((None, None, None), "same")),
]


@pytest.mark.parametrize("arch,tp,leaf,want", ODD_TP_CASES,
                         ids=[f"{a}-tp{t}-{'/'.join(l)}" for a, t, l, _ in ODD_TP_CASES])
def test_compute_layout_at_a_tp_that_divides_some_dims(arch, tp, leaf, want):
    cfg = tregistry.get(arch)
    params = tapi.init(cfg, device="meta")
    layout = dict(zip([_port_key(p) for p, _ in tree.leaves_with_paths(params)],
                      tshd.compute_layout(cfg, params, FakeMesh(data=1, model=tp))))
    assert layout[("blocks",) + leaf] == want


# the gradient kind of a leaf without and with sequence parallelism at full
# width: (arch, tp, leaf, kind, kind under sequence parallelism). A leaf every
# model rank holds whole and applies to its rows of the residual brings back
# a partial sum; one applied alike to the gathered sequence stays "same"
SEQ_LAYOUT_CASES = [
    ("qwen2.5-3b", 16, ("blocks", "attn_norm", "scale"), "same", "sum"),
    ("qwen2.5-3b", 16, ("final_norm", "scale"), "same", "sum"),
    ("qwen2.5-3b", 16, ("blocks", "attn", "wk", "w"), "sum", "sum"),
    ("qwen2.5-3b", 16, ("blocks", "attn", "wq", "b"), "shard", "shard"),
    # 16 heads and d_ff 11008 over 3: the whole attention runs on the gathered
    # sequence, the whole MLP on the rank's rows
    ("qwen2.5-3b", 3, ("blocks", "attn", "wq", "w"), "same", "same"),
    ("qwen2.5-3b", 3, ("blocks", "mlp", "wg", "w"), "same", "sum"),
    ("qwen2.5-3b", 3, ("blocks", "mlp", "wd", "w"), "same", "sum"),
    # 36 heads over 16; the odd vocabulary looked up whole and its rows kept
    ("minicpm-2b", 16, ("blocks", "attn", "wo", "w"), "same", "same"),
    ("minicpm-2b", 16, ("emb", "table"), "same", "same"),
    # d_ff over 5, d_model not: every rank computes all of wd's columns
    ("minicpm-2b", 5, ("blocks", "mlp", "wd", "w"), "same", "same"),
    ("dbrx-132b", 16, ("blocks", "moe", "router"), "same", "sum"),
    ("dbrx-132b", 16, ("blocks", "moe", "wg"), "shard", "shard"),
    ("dbrx-132b", 16, ("final_norm", "bias"), "same", "sum"),
    # the hybrid: the outer norms and the shared block's norms on the rows; the
    # Mamba2 layer's inner norm on the gathered sequence (its heads joined)
    ("zamba2-7b", 16, ("prologue", "norm", "scale"), "same", "sum"),
    ("zamba2-7b", 16, ("groups", "norm", "scale"), "same", "sum"),
    ("zamba2-7b", 16, ("groups", "mamba", "norm", "scale"), "same", "same"),
    ("zamba2-7b", 16, ("shared_attn", "mlp_norm", "scale"), "same", "sum"),
    ("zamba2-7b", 16, ("groups", "mamba", "in_proj", "w"), "sum", "sum"),
    # 112 Mamba2 heads over 32 do not split: the layer alike on the gathered
    # sequence, its outer norm on the rows
    ("zamba2-7b", 32, ("prologue", "mamba", "out_proj", "w"), "same", "same"),
    ("zamba2-7b", 32, ("prologue", "norm", "scale"), "same", "sum"),
    # RWKV6: ln0 / ln1 / ln2 on the rows; the mixes on the gathered sequence
    ("rwkv6-7b", 16, ("ln0", "bias"), "same", "sum"),
    ("rwkv6-7b", 16, ("blocks", "ln1", "scale"), "same", "sum"),
    ("rwkv6-7b", 16, ("blocks", "ln2", "bias"), "same", "sum"),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "maa_x"), "same", "same"),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "maa_w1"), "same", "same"),
    ("rwkv6-7b", 16, ("blocks", "block", "cmix", "maa_r"), "same", "same"),
    ("rwkv6-7b", 7, ("blocks", "block", "cmix", "wr", "w"), "same", "same"),
    # whisper: enc_norm / dec_norm and the cross-attention's norm on the rows;
    # pos_dec added to the whole sequence before the rows are taken; 20 heads
    # over 16: the attentions, their bias too, on the gathered sequence
    ("whisper-large-v3", 16, ("enc_norm", "scale"), "same", "sum"),
    ("whisper-large-v3", 16, ("dec_norm", "bias"), "same", "sum"),
    ("whisper-large-v3", 16, ("dec_blocks", "xattn_norm", "scale"), "same", "sum"),
    ("whisper-large-v3", 16, ("pos_dec",), "same", "same"),
    ("whisper-large-v3", 16, ("dec_blocks", "xattn", "wo", "b"), "same", "same"),
    ("whisper-large-v3", 4, ("dec_blocks", "xattn", "wo", "b"), "same", "sum"),
]


@pytest.mark.parametrize("arch,tp,leaf,kind,seq_kind", SEQ_LAYOUT_CASES,
                         ids=[f"{a}-tp{t}-{'/'.join(l)}" for a, t, l, _, _ in SEQ_LAYOUT_CASES])
def test_compute_layout_under_sequence_parallelism(arch, tp, leaf, kind, seq_kind):
    cfg = tregistry.get(arch)
    params = tapi.init(cfg, device="meta")
    keys = [_port_key(p) for p, _ in tree.leaves_with_paths(params)]
    mesh = FakeMesh(data=1, model=tp)
    whole = dict(zip(keys, tshd.compute_layout(cfg, params, mesh)))
    split = dict(zip(keys, tshd.compute_layout(cfg, params, mesh, seq=True)))
    assert whole[leaf][1] == kind and split[leaf][1] == seq_kind
    assert whole[leaf][0] == split[leaf][0]


# ---------------------------------------------------------------------------
# sharded training on 3 or 4 gloo ranks
# ---------------------------------------------------------------------------

# the jobs with the residual whole; the "-sp" jobs run the same checks in
# tests/test_torch_parallel_seq.py (tests/torch_sharded_train_checks.py)
@pytest.fixture(scope="module", params=[n for n, j in JOBS.items() if "residual" not in j])
def sharded_run(request, tmp_path_factory):
    return run_job(request.param, tmp_path_factory)


def test_a_split_contraction_moves_adam_past_the_parity_tolerance(monkeypatch):
    """Why the partitioned step keeps every product column-parallel (ROADMAP
    C32): on one device, the same 3 dbrx steps with every dense product's
    contraction summed as two halves (what a row-parallel product over two
    model ranks computes) keep the losses within ``TOL`` but move some
    parameter past it: C13's bf16 roundings in the loss turn the
    reassociation into gradient noise, and Adam's step on a near-zero
    gradient follows the noise."""
    job = JOBS["dbrx-132b"]
    args = (job["arch"], job["batch"], job["seq"], job["steps"], job["microbatches"])
    plain_metrics, plain = _single_device(*args)
    dense = tlayers.dense

    def halves(p, x, *, dtype=torch.bfloat16):
        k = p["w"].shape[0] // 2
        xd, w = x.to(dtype), p["w"].to(dtype)
        y = xd[..., :k] @ w[:k] + xd[..., k:] @ w[k:]
        return y + p["b"].to(dtype) if "b" in p else y

    monkeypatch.setattr(tlayers, "dense", halves)
    split_metrics, split = _single_device(*args)
    monkeypatch.setattr(tlayers, "dense", dense)
    for got, want in zip(split_metrics, plain_metrics):
        assert got["loss"] == pytest.approx(want["loss"], rel=TOL, abs=TOL)
    assert max(float(np.abs(a - b).max()) for a, b in zip(split, plain)) > TOL


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _losses(text):
    return [float(x) for x in re.findall(r"^step +\d+ loss=([0-9.]+)", text, re.M)]


def _torchrun(tmp_path, *args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced", *args]
    r = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True, text=True,
                       timeout=RANK_TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_train_launcher_under_torch_distributed_run(tmp_path, capsys):
    """``--dp 2 --tp 2`` on 4 gloo ranks prints the losses of the ``--dp 1
    --tp 1`` run: the same to the printed digits at ``--dp 1 --tp 4`` (no
    partial sums), within 1e-3 at ``--dp 2`` (bf16 compute: each data rank
    rounds its partial weight gradients, ROADMAP C26). The 2 x 2 run's
    checkpoint resumes under ``--dp 4 --tp 1``."""
    handler = signal.getsignal(signal.SIGTERM)       # the launcher installs its own
    try:
        assert tlaunch.main(["--device", "cpu", "--reduced", "--steps", "3",
                             "--ckpt-dir", str(tmp_path / "one")]) == 0
    finally:
        signal.signal(signal.SIGTERM, handler)
    one = _losses(capsys.readouterr().out)
    assert len(one) == 3
    out = _torchrun(tmp_path, "--dp", "1", "--tp", "4", "--steps", "3", "--ckpt-dir", "tp")
    assert _losses(out) == one
    out = _torchrun(tmp_path, "--dp", "2", "--tp", "2", "--steps", "3", "--ckpt-dir", "dp")
    assert "mesh (data 2, model 2) on 4 rank(s)" in out
    assert _losses(out) == pytest.approx(one, rel=1e-3)
    out = _torchrun(tmp_path, "--dp", "4", "--tp", "1", "--steps", "5", "--ckpt-dir", "dp")
    assert "[restart] resumed from step 3" in out
    assert re.findall(r"^step +(\d+)", out, re.M) == ["4", "5"]
