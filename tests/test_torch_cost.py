"""The port's eager cost counter (``repro_torch/utils/cost.py``), the kernels'
hook into it, the dry-run, and the roofline, held to the JAX package's
``hlo_cost`` and ``roofline`` on the CPU.

Tolerances: the counter's own cases, the kernel hook and the fake-mesh split
are exact; whole cells are held to the reference's ``hlo_cost`` FLOPs within
0.5 % under the same plan (``REL``), after the one closed-form term named at
``test_whole_cell_flops_match_the_reference``. The reference side compiles on
one JAX CPU device in this process; the port side runs in a subprocess, since
the port's cells need a process group (a ``"fake"`` one) and the test worker
must not hold one.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JShape
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.utils.hlo import hlo_cost
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import roofline as troofline
from repro_torch.launch import specs as tspecs
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttransformer
from repro_torch.utils import cost
from repro_torch.utils.cost import CostCounter

ROOT = Path(__file__).resolve().parent.parent
REL = 5e-3                      # whole cells: the port's FLOPs against hlo_cost's
SUBPROCESS_TIMEOUT = 300        # seconds
SMOKE_TIMEOUT = 120             # the full-width smoke's own limit


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _run(script, *args, timeout=SUBPROCESS_TIMEOUT):
    r = subprocess.run([sys.executable, "-c", script, *args], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _ref_flops(fn, *args):
    return hlo_cost(jax.jit(fn).lower(*args).compile().as_text())["flops"]


# ---------------------------------------------------------------------------
# the counter's own cases (tests/test_hlo_cost.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_flops_of_a_layer_loop_are_exact(device):
    x = torch.zeros(128, 256, device=device)
    ws = torch.zeros(8, 256, 256, device=device)
    with CostCounter() as c:
        for i in range(8):
            x = torch.tanh(x @ ws[i])
    assert c.flops == 8 * 2 * 128 * 256 * 256


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_attention_flops_exact(device):
    q = torch.zeros(2, 4, 128, 64, device=device)
    with CostCounter() as c:
        s = torch.einsum("bhld,bhsd->bhls", q, q)
        torch.einsum("bhls,bhsd->bhld", torch.softmax(s, -1), q)
    assert c.flops == 2 * (2 * 2 * 4 * 128 * 128 * 64)


def test_bytes_peak_and_top_bytes_of_an_op_chain():
    """Operand + result bytes of each op; views and empty count nothing; the
    peak is the largest sum of live storages the chain created."""
    x = torch.zeros(1000, device="meta")                   # an argument: 4000 bytes
    with CostCounter() as c:
        a = x * 2                                          # 4000 + 4000
        b = a + 1                                          # 4000 + 4000
        del a
        d = b * b                                          # 4000 * 3
        e = torch.cat([b, d])                              # 8000 + 8000, 16000 live
        e.view(2, 1000).t()                                # views: nothing
        torch.empty(10 ** 6, device="meta")                # empty: no bytes, freed at once
    assert c.bytes == 8000 + 8000 + 12000 + 16000
    assert c.instr_count == 4
    assert c.peak_bytes == 4 * 10 ** 6 + 16000             # the empty while b, d, e live
    # rows sum an op's calls at one result shape: the two muls make one row
    assert c.top_bytes(1) == [(20000.0, "aten.mul", "(1000,)", 2)]
    assert [r[1] for r in c.top_bytes(4)] == ["aten.mul", "aten.cat", "aten.add"]


def test_a_kernel_region_counts_nothing_beneath_it():
    x = torch.zeros(64, 64)
    with CostCounter() as c:
        with cost.kernel("k", lambda: (7, 11)):
            with c.kernel("inner", flops=1000, bytes=1000):
                x @ x
        x @ x
    assert c.flops == 7 + 2 * 64 ** 3 and dict(c.kernels) == {"k": 1}
    assert c.bytes == 11 + 3 * 64 * 64 * 4
    with cost.kernel("nothing active", lambda: 1 / 0):         # no counter: counts nothing
        pass


def test_the_open_counters_are_counted_through_a_raise():
    """``kernel`` reads the count of open counters before the mode stack: it
    is back at 0 once the counters are left, a raise inside included."""
    assert cost._open == 0
    with pytest.raises(ZeroDivisionError):
        with CostCounter():
            with CostCounter() as inner:
                assert cost._open == 2
                with cost.kernel("k", lambda a, b: (a, b), 3, 5):
                    pass
                1 / 0
    assert cost._open == 0 and dict(inner.kernels) == {"k": 1} and inner.flops == 3


COLLECTIVES_SCRIPT = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils.cost import CostCounter

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"))
    x = torch.empty(64, 32, device="meta")                 # 8192 bytes
    out = {}
    with CostCounter() as c:                               # c10d, the world of 4
        dist.all_gather_into_tensor(torch.empty(256, 32, device="meta"), x)
        dist.all_reduce(x)
        dist.reduce_scatter_tensor(torch.empty(16, 32, device="meta"), x)
    out["c10d"] = c.collective_bytes()
    with CostCounter() as c:                               # functional, a group of 2
        g = mesh.get_group("data")
        funcol.all_gather_tensor(x, 0, g)
        funcol.all_reduce(x, "sum", g)
        funcol.reduce_scatter_tensor(x, "sum", 0, g)
    out["functional"] = c.collective_bytes()
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_collective_wire_bytes_follow_the_reference_formulas():
    """b = result bytes, g = the op's own group: all-gather b(g-1)/g,
    all-reduce 2b(g-1)/g, reduce-scatter b(g-1)."""
    got = _run(COLLECTIVES_SCRIPT)
    b = 64 * 32 * 4
    want4 = {"all-gather": 4 * b * 3 / 4, "all-reduce": 2 * b * 3 / 4,
             "reduce-scatter": b / 4 * 3}
    want2 = {"all-gather": 2 * b / 2, "all-reduce": 2 * b / 2, "reduce-scatter": b / 2}
    for kind, want in (("c10d", want4), ("functional", want2)):
        assert got[kind] == {**want, **{f"count_{k}": 1 for k in want},
                             "total": sum(want.values())}, kind


# ---------------------------------------------------------------------------
# the kernels' hook, against hlo_cost of flash_ref and decode_attend
# ---------------------------------------------------------------------------

B, H, HKV, D = 2, 4, 2, 16


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [512, 700])
def test_forward_hook_counts_what_hlo_cost_counts_for_flash_ref(S, causal, device):
    q = jax.ShapeDtypeStruct((B, S, H, D), jnp.float32)
    kv = jax.ShapeDtypeStruct((B, S, HKV, D), jnp.float32)
    want = _ref_flops(partial(jattn.flash_ref, causal=causal), q, kv, kv)
    tq = torch.zeros(B, S, H, D, device=device)
    tk = torch.zeros(B, S, HKV, D, device=device)
    with CostCounter() as c:
        o = ops.mha_forward(tq, tk, tk, causal=causal)
    assert c.flops == want and dict(c.kernels) == {"flash_attention": 1}
    assert c.bytes == 2 * (tq.numel() + tk.numel()) * 4      # q, k, v and o
    assert o.shape == tq.shape and o.device.type == device


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_decode_hook_counts_what_hlo_cost_counts_for_decode_attend(device):
    S = 700
    q = jax.ShapeDtypeStruct((B, 1, H, D), jnp.float32)
    kv = jax.ShapeDtypeStruct((B, S, HKV, D), jnp.float32)
    want = _ref_flops(lambda q, k, v: jattn.decode_attend(q, k, v, S), q, kv, kv)
    tq = torch.zeros(B, 1, H, D, device=device)
    tk = torch.zeros(B, S, HKV, D, device=device)
    with CostCounter() as c:
        o = ops.decode_forward(tq, tk, tk, S)
    assert c.flops == want == 4 * B * H * S * D
    assert dict(c.kernels) == {"flash_decode": 1}
    assert c.bytes == (2 * tq.numel() + 2 * tk.numel()) * 4
    assert o.shape == tq.shape
    with CostCounter() as c:                                   # the partials' route
        acc, m, l = ops.decode_forward(tq, tk, tk, 300, return_partials=True)
    assert c.flops == 4 * B * H * 300 * D
    assert (acc.shape, m.shape, l.dtype) == ((B, H, D), (B, H), torch.float32)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_backward_counts_the_four_gradient_products_once(device):
    S = 700
    q = torch.zeros(B, S, H, D, device=device, requires_grad=True)
    k = torch.zeros(B, S, HKV, D, device=device, requires_grad=True)
    with CostCounter() as c:
        o = ops.mha_forward(q, k, k, causal=True)
        dq, dk = torch.autograd.grad(o.sum(), [q, k])
    fwd = 4 * B * H * S * 1024 * D
    # the gradient's own products: o.sum()'s backward is an expand, no dot
    assert c.flops == fwd + 8 * B * H * S * 1024 * D
    assert dict(c.kernels) == {"flash_attention": 1, "flash_attention_bwd": 1}
    assert dq.shape == q.shape and dk.shape == k.shape
    assert tfa.forward_flops(q.transpose(1, 2), k.transpose(1, 2)) == fwd


# ---------------------------------------------------------------------------
# whole cells: the dry-run's records against the reference's
# ---------------------------------------------------------------------------

TRAIN, PREFILL, DECODE = (JShape("train_s", 64, 8, "train"), JShape("prefill_s", 64, 4, "prefill"),
                          JShape("decode_s", 64, 4, "decode"))
# the loss in two chunks: at one chunk XLA merges the checkpointed loss body's
# recompute with its forward (prevent_cse=False in a scan of one trip)
LOSS_CHUNK = 256
CELLS = [("olmo-1b", TRAIN), ("olmo-1b", PREFILL), ("olmo-1b", DECODE),
         ("dbrx-132b", TRAIN), ("zamba2-7b", TRAIN), ("rwkv6-7b", TRAIN),
         ("whisper-large-v3", TRAIN)]
# the train cells also counted on a fake (2, 2) mesh; a dbrx rank's 256 tokens
# would be fewer than one MoE dispatch group (ROADMAP C27)
SPLIT = [("olmo-1b", TRAIN), ("zamba2-7b", TRAIN), ("rwkv6-7b", TRAIN),
         ("whisper-large-v3", TRAIN)]
PLAN_FIELDS = [f.name for f in dataclasses.fields(tspecs.CellPlan)]


def _ref_plan(arch, shape):
    cfg = jregistry.get(arch).reduced()
    mesh = jmesh.make_mesh((1, 1), ("data", "model"))
    return cfg, mesh, dataclasses.replace(jspecs.plan_cell(cfg, shape, mesh),
                                          loss_chunk=LOSS_CHUNK)


PORT_CELLS_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import trainer

    jobs, out = json.loads(sys.argv[1]), {}
    partitioned = trainer.route
    for dims in ([1, 1], [2, 2]):
        dryrun.init_fake_group(dims[0] * dims[1])
        mesh = make_mesh(dims, ("data", "model"))
        for job in jobs:
            if dims == [2, 2] and not job["split"]:
                continue
            cfg = registry.get(job["arch"]).reduced()
            routes = {"": partitioned}
            if dims == [2, 2] and partitioned(cfg) == "partitioned":
                routes["-gathered"] = lambda cfg: "gathered"       # C25's route, to compare
            for suffix, route in routes.items():
                trainer.route = route
                rec = dryrun.run_cell(cfg, ShapeConfig(*job["shape"]), mesh,
                                      "x".join(map(str, dims)),
                                      plan=specs.CellPlan(**job["plan"]))
                out[f"{job['arch']}|{job['shape'][0]}|{rec['mesh']}{suffix}"] = rec
    trainer.route = partitioned
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def port_records():
    jobs = []
    for arch, shape in CELLS:
        _, _, plan = _ref_plan(arch, shape)
        jobs.append(dict(arch=arch, shape=dataclasses.astuple(shape),
                         plan={f: getattr(plan, f) for f in PLAN_FIELDS},
                         split=(arch, shape) in SPLIT))
    return _run(PORT_CELLS_SCRIPT, json.dumps(jobs))


def _ref_dryrun():
    """The reference's dry-run module, imported without its XLA_FLAGS line
    taking effect (the backend is already up; the variable is put back)."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as m
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return m


def _ref_record(arch, shape):
    cfg, mesh, plan = _ref_plan(arch, shape)
    return _ref_dryrun().run_cell(cfg, shape, mesh, "1x1", plan=plan)


def _mamba_forward_flops(cfg, batch, seq):
    """Dot FLOPs of one Mamba2 layer's forward (models/mamba.py): in_proj,
    the chunked SSD's four products a chunk, out_proj."""
    N, Q = cfg.ssm_state, min(cfg.ssm_chunk, seq)
    d_inner = cfg.ssm_expand * cfg.d_model
    p, nh = 64, cfg.ssm_expand * cfg.d_model // 64
    chunks = -(-seq // Q)
    proj = 2 * batch * seq * cfg.d_model * (2 * d_inner + 2 * N + nh + d_inner)
    ssd = chunks * (2 * batch * Q * Q * N + 2 * batch * Q * Q * nh * p
                    + 2 * 2 * batch * Q * N * nh * p)
    return proj + ssd


def test_mamba_forward_closed_form_is_the_counters():
    cfg = tregistry.get("zamba2-7b").reduced()
    blk = tapi.init(cfg, device="meta")["groups"][0][0]
    x = torch.empty(TRAIN.global_batch, TRAIN.seq_len, cfg.d_model, device="meta")
    with CostCounter() as c:
        ttransformer._mamba_layer_apply(blk, x, cfg)
    assert c.flops == _mamba_forward_flops(cfg, TRAIN.global_batch, TRAIN.seq_len)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s.kind}" for a, s in CELLS])
def test_whole_cell_flops_match_the_reference(port_records, arch, shape):
    """The port's FLOPs a device on a (1, 1) mesh against ``hlo_cost`` of the
    reference's cell compiled on one device, under the reference's plan.

    One term is closed form: in a hybrid train step the port checkpoints each
    group and each Mamba2 layer in it, so the backward runs every inner
    layer's forward twice (the group's recompute, then the layer's own); XLA
    merges the two (``jax.checkpoint(..., prevent_cse=False)``). The test takes
    one forward of the groups' Mamba2 layers off the port's count."""
    got = port_records[f"{arch}|{shape.name}|1x1"]["flops_per_device"]
    want = _ref_record(arch, shape)["flops_per_device"]
    if arch == "zamba2-7b":
        cfg = tregistry.get(arch).reduced()
        inner = cfg.hybrid_groups * cfg.hybrid_mamba_per_group
        got -= inner * _mamba_forward_flops(cfg, shape.global_batch, shape.seq_len)
    assert got == pytest.approx(want, rel=REL), (arch, shape.kind, got, want)
    if arch == "olmo-1b":
        assert got == want                      # the dense family's count is exact


def _rwkv_whole_flops(cfg, batch, seq):
    """Dot FLOPs of an RWKV6 train step's products that no layout splits over
    ``model`` (``sharding.model_layout``, as the reference's rules leave them
    unsplit): each layer's ``maa_w1`` (d x 5 LORA_MIX), the ``maa_w2`` einsum
    (5 x LORA_MIX x d) and ``decay_w1`` (d x LORA_DECAY), each run forward,
    again in the remat recompute, and backward for its input and its weight."""
    from repro_torch.models import rwkv
    macs = cfg.d_model * (2 * rwkv.N_MIX * rwkv.LORA_MIX + rwkv.LORA_DECAY)
    return 4 * 2 * macs * batch * seq * cfg.num_layers


def test_a_2x2_mesh_halves_a_train_cell(port_records):
    """A1 and A1b: a (2, 2) mesh partitions the dots of a train cell over data
    and model, so a device does more than a quarter of one device's FLOPs
    and, for olmo-1b, zamba2-7b and whisper-large-v3, at most 0.3 of them: a
    quarter, and the joined products' recomputes (remat "full": the backward
    re-runs a joined product to get its gathered input back, where one
    device's checkpoint stops short of it; without remat olmo's count is a
    quarter exactly). The terms that stay replicated over model (the norms,
    the residual adds, rope, the loss's log-sum-exp, Mamba2's C·B product)
    are no dots or small ones. rwkv6-7b's LoRA mixes (``_rwkv_whole_flops``)
    are about a third of its products at d 64 (their rank does not shrink
    with d) and stay whole, alike on every model rank, as the reference's
    rules leave them: its device does a quarter of the split products' FLOPs
    and half of the whole ones', within olmo-1b's allowance of 0.05 of one
    device's. The inputs' gradients are summed over the model ranks
    (all-reduces on the wire), and a device holds its model shard of each
    parameter and of its gradient: its peak is below that of C25's route,
    which gathers every parameter whole and computes each data rank's rows
    at full width, half of one device's FLOPs a device (counted here too)."""
    for arch, shape in SPLIT:
        one = port_records[f"{arch}|{shape.name}|1x1"]
        four = port_records[f"{arch}|{shape.name}|2x2"]
        c25 = port_records[f"{arch}|{shape.name}|2x2-gathered"]
        assert four["collective_bytes_per_device"] > 0 == one["collective_bytes_per_device"]
        assert four["collective_counts"]["count_all-gather"] > 0
        assert four["collective_counts"]["count_all-reduce"] > 0
        assert four["devices"] == 4
        assert c25["flops_per_device"] * 2 == one["flops_per_device"], arch
        assert four["mem"]["peak_bytes"] < c25["mem"]["peak_bytes"], arch
        f1, f4 = one["flops_per_device"], four["flops_per_device"]
        top = 0.3 * f1
        if arch == "rwkv6-7b":
            whole = _rwkv_whole_flops(tregistry.get(arch).reduced(), shape.global_batch,
                                      shape.seq_len)
            top = (f1 - whole) / 4 + whole / 2 + 0.05 * f1
        assert f1 / 4 < f4 <= top, (arch, f4 / f1)


NO_COUNTERPART = {"xla_flops_per_device", "xla_bytes_per_device", "t_lower_s", "t_compile_s"}


def test_record_keys_are_the_reference_less_the_named_list(port_records):
    want = _ref_record("olmo-1b", DECODE)
    got = port_records[f"olmo-1b|{DECODE.name}|1x1"]
    assert set(got) == (set(want) - NO_COUNTERPART) | {"t_run_s"}
    assert set(got["mem"]) == set(want["mem"]) - {"generated_code_bytes"}
    assert got["plan"] == want["plan"]
    assert got["mem"]["peak_bytes"] == got["mem"]["argument_bytes"] + got["mem"]["temp_bytes"]


def test_analyze_record_with_the_reference_constants_is_the_reference(port_records):
    key = f"olmo-1b|{TRAIN.name}|2x2"
    rec = dict(port_records[key], arch="olmo-1b")
    want = jroofline.analyze_record(key, rec)
    got = troofline.analyze_record(key, rec, peak_flops=jroofline.PEAK_FLOPS,
                                   hbm_bw=jroofline.HBM_BW, link_bw=jroofline.ICI_BW)
    assert got == want
    h100 = troofline.analyze_record(key, rec)
    assert h100["t_compute_s"] == rec["flops_per_device"] / 989e12
    assert h100["t_memory_s"] == rec["bytes_per_device"] / 3.35e12
    assert h100["t_collective_s"] == rec["collective_bytes_per_device"] / 50e9
    assert troofline.analyze_record(key, {"status": "error"}) is None
    md = troofline.to_markdown({key: dict(h100, mesh="single_pod_16x16")})
    assert "| olmo-1b | train_s |" in md


def test_full_width_dryrun_smoke_on_512_fake_ranks(tmp_path):
    """olmo-1b train_4k on the 2 x 16 x 16 fake group. The partitioned step
    (A1) gathers each parameter over the data axes only: a rank holds its
    model shard of the fp32 parameters and of their gradients, 1/16 of them,
    beside its tokens' activations, so its peak is below the 2 x 4.7 GB of
    gathered parameters and gradients that C25's route held."""
    out = tmp_path / "dry.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b",
         "--shape", "train_4k", "--mesh", "multi", "--out", str(out), "--force"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=SMOKE_TIMEOUT)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    rec = json.loads(out.read_text())["olmo-1b|train_4k|multi_pod_2x16x16"]
    assert rec["status"] == "ok" and rec["devices"] == 512
    assert rec["flops_per_device"] > 0 and rec["collective_bytes_per_device"] > 0
    assert rec["mem"]["peak_bytes"] < tspecs.HBM_BUDGET
    n_params = tregistry.get("olmo-1b").param_count()
    assert rec["mem"]["peak_bytes"] < 2 * 4 * n_params          # params + gradients


def test_modules_import_neither_jax_nor_the_reference():
    code = ("import sys; import repro_torch.utils.cost, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, repro_torch.launch.perf; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); assert not bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


def test_model_flops_mirror_the_reference():
    for arch in ("olmo-1b", "dbrx-132b", "rwkv6-7b"):
        for kind, tokens in (("train", 1 << 20), ("decode", 128)):
            assert troofline.model_flops_total(arch, kind, tokens) == \
                jroofline.model_flops_total(arch, kind, tokens)
    assert math.isclose(troofline.PEAK_FLOPS / troofline.HBM_BW, 989 / 3.35)
