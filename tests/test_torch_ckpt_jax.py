"""The port's checkpoint manager reading steps that the JAX package's manager
wrote (``CheckpointManager.restore`` given ``compat.jax_layout``): every family's
train state,
``ef_error``, bf16 leaves, a target of another arch, a one-layer config; and
the port's launcher resuming the JAX launcher's step, on one device and on a
2 x 2 gloo mesh. On the CPU, against the JAX package's own train step."""
import contextlib
import dataclasses
import io
import json
import shutil
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.ckpt.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import registry as jregistry
from repro.data.synthetic import token_batch
from repro.launch import train as jlaunch
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import compat, tree
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry as tregistry
from repro_torch.launch import train as tlaunch
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

from test_torch_models import reference_mlp_follows_compute_dtype  # noqa: F401
from test_torch_parallel import _run_ranks

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
# the reference's fp32 tolerance (tests/test_kernels.py); both sides compute
# in fp32 from the same state and batch
TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(arch, **replace):
    kw = {"compute_dtype": "float32", **replace}
    return (dataclasses.replace(jregistry.get(arch).reduced(), **kw),
            dataclasses.replace(tregistry.get(arch).reduced(), **kw))


def _batch(cfg, step):
    b = token_batch(cfg, batch=2, seq=16, step=step)
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_state_after(cj, run_kw, steps):
    """The reference's own init (key 0) after ``steps`` of its jitted train step,
    and the step."""
    run = jtrainer.RunConfig(opt=jopt.OptConfig(**OPT), **run_kw)
    step = jax.jit(jtrainer.make_train_step(cj, run))
    state = jtrainer.init_state(cj, run, jax.random.PRNGKey(0))
    for i in range(steps):
        state, _ = step(state, _batch(cj, i)[0])
    return state, step


def _restore(directory, step, target):
    """``(state, layout)``: step ``step`` of ``directory`` restored into the
    port's train state ``target``, in the layout its manifest matches."""
    mgr, stacked = CheckpointManager(directory), compat.jax_layout(target)
    return (mgr.restore(step, target, stacked=stacked),
            mgr.layout(step, target, stacked))


def _equal_bits(a, b):
    a, b = a.detach(), b.detach()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


# each family; minicpm with int8 gradient compression, whose error feedback
# (``ef_error``, a params-shaped tree) crosses too
CASES = {"olmo-1b": {}, "pixtral-12b": {}, "dbrx-132b": {}, "zamba2-7b": {}, "rwkv6-7b": {},
         "whisper-large-v3": {}, "minicpm-2b": {"grad_compress": "int8"}}


@pytest.mark.parametrize("arch", list(CASES))
def test_a_jax_checkpoint_restores_and_resumes(arch, tmp_path,
                                               reference_mlp_follows_compute_dtype):
    """Two reference steps saved by the reference's manager: the port restores
    them into its own fresh state bit for bit equal to ``train_state_from_jax``
    of the reference's state in memory, and one more step on each side agrees
    in the loss, the gradient norm and every parameter within 2e-5."""
    run_kw = dict(remat="none", **CASES[arch])
    cj, ct = _cfgs(arch)
    sj, step_j = _jax_state_after(cj, run_kw, 2)
    JaxCheckpointManager(tmp_path, async_save=False).save(2, sj)

    run = ttrainer.RunConfig(opt=topt.OptConfig(**OPT), **run_kw)
    target = ttrainer.init_state(ct, run, 1, device="cpu")
    st, layout = _restore(tmp_path, 2, target)
    assert layout == "jax"
    want = compat.train_state_from_jax(ct, jax.tree.map(np.asarray, sj), device="cpu")
    assert (st.ef_error is None) == (arch != "minicpm-2b")
    got_leaves, want_leaves = tree.leaves(st), tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(tree.leaves(target))
    for (path, a), b, t in zip(tree.leaves_with_paths(st), want_leaves, tree.leaves(target)):
        assert _equal_bits(a, b), path
        assert a.requires_grad == t.requires_grad, path
    assert st.opt_state.step.dtype == torch.int32 and st.opt_state.step.dim() == 0
    assert int(st.opt_state.step) == 2

    bj, bt = _batch(cj, 2)
    sj, mj = step_j(sj, bj)
    st, mt = ttrainer.make_train_step(ct, run)(st, bt)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL, err_msg=k)
    params = zip(jax.tree_util.tree_leaves_with_path(sj.params),
                 jax.tree.leaves(compat.params_to_jax(ct, st.params)))
    if st.ef_error is None:
        for (path, b), a in params:
            np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                       err_msg=jax.tree_util.keystr(path))
        return
    for ((path, b), a), eb, ea in zip(params, jax.tree.leaves(sj.ef_error),
                                      jax.tree.leaves(compat.params_to_jax(ct, st.ef_error))):
        _close_but_int8_flips(a, np.asarray(b), ea, np.asarray(eb),
                              jax.tree_util.keystr(path))


def _close_but_int8_flips(got, want, ef_got, ef_want, name):
    """int8 compression rounds each gradient element to a multiple of its
    leaf's scale: where the two sides' fp32 gradients straddle a rounding
    boundary they take neighbouring levels, and their error feedback differs
    by one scale. Such elements may be at most one in a thousand of a leaf,
    their parameters a few learning rates apart (one Adam step moves an
    element by about lr); every other element of the parameter and of its
    error feedback is held to ``TOL``."""
    flip = ~np.isclose(ef_got, ef_want, **TOL)
    assert flip.sum() <= flip.size // 1000, (name, int(flip.sum()))
    np.testing.assert_allclose(ef_got[~flip], ef_want[~flip], **TOL, err_msg=name)
    np.testing.assert_allclose(got[~flip], want[~flip], **TOL, err_msg=name)
    assert np.all(np.abs(got - want)[flip] <= 4 * OPT["lr"]), name


def test_bf16_leaves_come_back_bit_for_bit(tmp_path):
    """A bf16 params tree saved by the reference's manager (``ml_dtypes``
    arrays, a 2-byte void type in the file) is read through its uint16 bits."""
    import ml_dtypes                                # the test's alone: the port reads bits

    cj, ct = _cfgs("zamba2-7b")
    sj, _ = _jax_state_after(cj, {"remat": "none"}, 1)
    bf = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16), sj.params)
    sj = sj._replace(params=bf)
    JaxCheckpointManager(tmp_path, async_save=False).save(1, sj)
    arr = np.load(tmp_path / "step_1" / "arr_0.npy")
    assert arr.dtype.itemsize == 2 and arr.dtype.kind == "V"

    run = ttrainer.RunConfig()
    target = ttrainer.init_state(ct, run, 1, device="cpu")
    target = target._replace(params=tree.map_leaves(
        lambda p: p.detach().to(torch.bfloat16).requires_grad_(True), target.params))
    st, layout = _restore(tmp_path, 1, target)
    assert layout == "jax"
    want = compat.params_from_jax(
        ct, jax.tree.map(lambda a: np.asarray(a).view(np.uint16), bf), device="cpu")
    for (path, a), b in zip(tree.leaves_with_paths(st.params), tree.leaves(want)):
        assert a.dtype == torch.bfloat16 and a.requires_grad, path
        assert torch.equal(a.detach().view(torch.int16), b.view(torch.int16)), path
    # C14: the dtype is checked, never cast
    with pytest.raises(ValueError, match="float32"):
        _restore(tmp_path, 
            1, ttrainer.init_state(ct, run, 1, device="cpu"))


def test_a_checkpoint_of_another_arch_raises_naming_a_leaf(tmp_path):
    cj, _ = _cfgs("qwen2.5-3b")
    sj, _ = _jax_state_after(cj, {"remat": "none"}, 0)
    JaxCheckpointManager(tmp_path, async_save=False).save(0, sj)
    _, ct = _cfgs("olmo-1b")
    target = ttrainer.init_state(ct, ttrainer.RunConfig(), 0, device="cpu")
    with pytest.raises(ValueError, match=r"neither layout.*port's \(leaf \d+ params/.*"
                                         r"JAX package's \(leaf \d+ params/"):
        _restore(tmp_path, 0, target)


def test_a_one_layer_config_reads_each_layout_by_its_manifest(tmp_path):
    """At one layer a stacked leaf is (1, ...) where the port's is (...): each
    step is read in the layout it was written in. The port's own step restores
    as ``restore`` restores it."""
    cj, ct = _cfgs("olmo-1b", num_layers=1)
    sj, _ = _jax_state_after(cj, {"remat": "none"}, 1)
    JaxCheckpointManager(tmp_path, async_save=False).save(1, sj)
    mgr = CheckpointManager(tmp_path, async_save=False)
    run = ttrainer.RunConfig()
    port_state = ttrainer.init_state(ct, run, 3, device="cpu")
    mgr.save(2, port_state)

    target = ttrainer.init_state(ct, run, 1, device="cpu")
    from_jax, layout = _restore(tmp_path, 1, target)
    assert layout == "jax"
    want = compat.train_state_from_jax(ct, jax.tree.map(np.asarray, sj), device="cpu")
    assert all(_equal_bits(a, b) for a, b in zip(tree.leaves(from_jax), tree.leaves(want)))
    own, layout = _restore(tmp_path, 2, target)
    assert layout == "port"
    again = mgr.restore(2, target)
    for a, b, c in zip(tree.leaves(own), tree.leaves(port_state), tree.leaves(again)):
        assert _equal_bits(a, b) and _equal_bits(a, c)


# a step that the JAX package's manager wrote, committed: chip_smoke.py restores
# it on the card (``PYTHONPATH=src:tests python tests/test_torch_ckpt_jax.py``
# writes it again)
JAX_CKPT = Path(__file__).resolve().parent / "data" / "jax_ckpt_olmo-1b"


def write_reference_checkpoint(directory):
    """olmo-1b reduced after two of the reference's train steps, saved by the
    reference's manager at step 2 under ``directory``; returns the state."""
    cj, _ = _cfgs("olmo-1b")
    sj, _ = _jax_state_after(cj, {"remat": "none"}, 2)
    JaxCheckpointManager(directory, async_save=False).save(2, sj)
    return sj


def test_the_committed_jax_checkpoint_is_the_reference_managers(tmp_path):
    """The committed step is what ``write_reference_checkpoint`` writes (the
    same leaves in its manifest, the arrays within 2e-5), the reference's
    manager restores it, and the port reads it in the JAX layout bit for bit
    equal to ``train_state_from_jax`` of the reference's restore."""
    sj = write_reference_checkpoint(tmp_path)
    committed, fresh = JAX_CKPT / "step_2", tmp_path / "step_2"
    leaves = json.loads((committed / "manifest.json").read_text())["leaves"]
    assert leaves == json.loads((fresh / "manifest.json").read_text())["leaves"]
    for meta in leaves:
        np.testing.assert_allclose(np.load(committed / meta["file"]),
                                   np.load(fresh / meta["file"]), **TOL, err_msg=meta["file"])
    back = JaxCheckpointManager(JAX_CKPT).restore(2, sj)
    _, ct = _cfgs("olmo-1b")
    st, layout = _restore(JAX_CKPT, 2, ttrainer.init_state(ct, ttrainer.RunConfig(), 0,
                                                           device="cpu"))
    assert layout == "jax"
    want = compat.train_state_from_jax(ct, jax.tree.map(np.asarray, back), device="cpu")
    for (path, a), b in zip(tree.leaves_with_paths(st), tree.leaves(want)):
        assert _equal_bits(a, b), path


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

LAUNCH = ["--reduced", "--steps", "6", "--ckpt-every", "3"]


def _losses(out):
    return {int(line.split()[1]): float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith("step ")}


def _in_fp32(mp, registry):
    """``registry.get`` giving each config in fp32 compute, for the length of
    ``mp``: in the launchers' bf16 compute the two packages' losses differ by
    their bf16 roundings (``tests/test_torch_train.py`` holds a bf16 step-1
    loss to 2e-2), in fp32 by the order of their sums."""
    get = registry.get
    mp.setattr(registry, "get",
               lambda name: dataclasses.replace(get(name), compute_dtype="float32"))


def _auto_axes_mesh(make_mesh):
    """``jax.make_mesh`` with Auto axes: from jax 0.7 it makes Explicit axes by
    default, under which the reference launcher's embedding gather from a
    table sharded over (model, data) raises a ``ShardingTypeError``; the
    launcher was written for the Auto axes of the JAX it came with (on one
    device the two compute the same numbers)."""
    def mesh(shape, names, **kw):
        return make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(names), **kw)
    return mesh


@pytest.fixture(scope="module")
def jax_launch(tmp_path_factory):
    """The reference's launcher run in this process (its SIGTERM handler put
    back: it leaves its own installed, ROADMAP C31): (its step_3 directory,
    its printed losses a step)."""
    from functools import partial
    from repro.models import layers as jlayers
    ck = tmp_path_factory.mktemp("jax_launch")
    out = io.StringIO()
    handler = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
            mp.setattr(jax, "make_mesh", _auto_axes_mesh(jax.make_mesh))
            _in_fp32(mp, jlaunch.registry)
            # as reference_mlp_follows_compute_dtype does for one test
            mp.setattr(jlayers, "apply_mlp", partial(jlayers.apply_mlp, dtype=jnp.float32))
            assert jlaunch.main(LAUNCH + ["--ckpt-dir", str(ck)]) == 0
    finally:
        signal.signal(signal.SIGTERM, handler)
    return ck / "step_3", _losses(out.getvalue())


def test_the_port_launcher_resumes_the_jax_launchers_step(jax_launch, tmp_path, capsys,
                                                          monkeypatch,
                                                          reference_mlp_follows_compute_dtype):
    """Steps 4-6 after the JAX launcher's step 3, both launchers in fp32
    compute: the same losses as its own run printed (four decimals: within one
    unit of the last). The directory then holds the JAX step 3 and the port's
    step 6, each read by its own manifest."""
    step3, want = jax_launch
    ck = tmp_path / "ck"
    shutil.copytree(step3, ck / "step_3")
    _in_fp32(monkeypatch, tlaunch.registry)
    assert tlaunch.main(["--device", "cpu", "--ckpt-dir", str(ck)] + LAUNCH) == 0
    out = capsys.readouterr().out
    assert "[restart] resumed from step 3\n" in out
    assert "[restart] read the jax checkpoint layout" in out
    got = _losses(out)
    assert sorted(got) == [4, 5, 6]
    for s in got:
        assert abs(got[s] - want[s]) <= 1e-4 + 1e-9, (s, got[s], want[s])
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [3, 6]
    cfg = tlaunch.registry.get("olmo-1b").reduced()
    target = ttrainer.init_state(cfg, ttrainer.RunConfig(), 0, device="cpu")
    assert [_restore(ck, s, target)[1] for s in (3, 6)] == ["jax", "port"]


def test_the_port_launcher_resumes_a_jax_step_0(jax_launch, tmp_path, capsys, monkeypatch,
                                               reference_mlp_follows_compute_dtype):
    """A step 0 (what a ``--steps 0`` run saves: the JAX launcher's init) is
    resumed, not replaced by the port's own init: steps 1-6 give the JAX
    launcher's losses."""
    _, want = jax_launch
    cj, _ = _cfgs("olmo-1b")
    JaxCheckpointManager(tmp_path, async_save=False).save(
        0, _jax_state_after(cj, {"remat": "none"}, 0)[0])
    _in_fp32(monkeypatch, tlaunch.registry)
    assert tlaunch.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)] + LAUNCH) == 0
    out = capsys.readouterr().out
    assert "[restart] resumed from step 0\n" in out
    got = _losses(out)
    assert sorted(got) == [1, 2, 3, 4, 5, 6]
    for s in got:
        assert abs(got[s] - want[s]) <= 1e-4 + 1e-9, (s, got[s], want[s])


def _one_device_resumed_steps(ckpt_dir, arch, job):
    """The worker job's resumed steps on one device: (metrics, parameters)."""
    from torch_sharded_worker import run_config
    from repro_torch.data.synthetic import DataIterator
    cfg = dataclasses.replace(tregistry.get(arch).reduced(), compute_dtype="float32")
    run = run_config(cfg, job)
    state, layout = _restore(
        ckpt_dir, 3, ttrainer.init_state(cfg, run, 0, device="cpu"))
    assert layout == "jax"
    step = ttrainer.make_train_step(cfg, run)
    data = DataIterator(cfg, batch=job["batch"], seq=job["seq"], start_step=3)
    metrics = []
    for _ in range(3, job["steps"]):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in next(data).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [p.detach().numpy() for p in tree.leaves(state.params)]


def test_a_jax_checkpoint_resumes_on_a_2x2_gloo_mesh(jax_launch, tmp_path):
    """The worker restores the JAX launcher's step 3 onto its 2 x 2 mesh
    (``trainer.shard_state``'s placements) and trains to step 6 with the
    launcher's settings: within 1e-5 of the same resumed steps on one device."""
    step3, _ = jax_launch
    ck = tmp_path / "jax_ckpt"
    shutil.copytree(step3, ck / "step_3")
    job = dict(arch="olmo-1b", mesh=[2, 2], batch=8, seq=64, steps=6, microbatches=1,
               remat="none", resume=str(ck))
    out = _run_ranks(tmp_path, job)
    assert out["resumed"] == {"step": 3, "layout": "jax"}
    metrics, params = _one_device_resumed_steps(ck, "olmo-1b", job)
    assert len(out["metrics"]) == len(metrics) == 3
    for got, want in zip(out["metrics"], metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for a, b in zip(out["params"], params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    shutil.rmtree(JAX_CKPT, ignore_errors=True)
    write_reference_checkpoint(JAX_CKPT)
