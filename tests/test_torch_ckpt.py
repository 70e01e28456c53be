"""The port's checkpoint manager, resume, train-state hand-over and training
launcher: torch ports of tests/test_ckpt_trainer.py's checkpoint tests and of
tests/test_launchers.py::test_train_launcher, on the CPU."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import compat, tree
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import registry as tregistry
from repro_torch.data.synthetic import DataIterator
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import MeshSizeError
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

ROOT = Path(__file__).resolve().parent.parent


def _cfg():
    return tregistry.get("olmo-1b").reduced()


def _run_cfg(**kw):
    return ttrainer.RunConfig(opt=topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50), **kw)


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def test_ckpt_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2, async_save=False)
    t = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (10, 20, 30):
        mgr.save(step, tree.map_leaves(lambda x: x + step, t))
    assert mgr.all_steps() == [20, 30]          # retention pruned step 10
    step, restored = mgr.restore_latest(t)
    assert step == 30
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(6).reshape(2, 3) + 30)
    np.testing.assert_array_equal(restored["b"]["c"].numpy(), np.full(4, 31.0))


def test_ckpt_async_save_publishes_atomically(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=3, async_save=True)
    t = {"w": torch.ones((64, 64))}
    mgr.save(1, t)
    t["w"] += 1.0                 # the snapshot was taken before save returned
    mgr.wait()
    assert (tmp_path / "step_1" / "manifest.json").exists()
    assert not list(tmp_path.glob("*.tmp"))
    assert float(mgr.restore(1, t)["w"].max()) == 1.0


def test_ckpt_async_failure_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, async_save=True)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", broken)
    mgr.save(1, {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []                 # never published
    mgr.wait()                                   # the error is raised once


def test_ckpt_restore_validates_structure(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="incompatible structure"):
        mgr.restore(1, {"w": torch.ones(3), "extra": torch.ones(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, {"w": torch.ones(5)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore(1, {"w": torch.ones(3, dtype=torch.bfloat16)})


def test_ckpt_bf16_leaves_structure_and_placement(tmp_path):
    """A bf16 leaf round-trips bit for bit (stored as uint16 bits); NamedTuples,
    lists and a None subtree keep their shape; requires_grad follows the target."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    bits = torch.from_numpy(np.random.default_rng(0).integers(0, 2**16, 257, dtype=np.uint16)
                            .view(np.int16))
    bf = bits.view(torch.bfloat16)                  # every pattern, NaNs included
    state = ttrainer.TrainState(
        params={"emb": {"table": torch.randn(4, 2, requires_grad=True)},
                "blocks": [{"w": bf.clone()}, {"w": torch.zeros(3, dtype=torch.int32)}]},
        opt_state=topt.OptState(m={"x": torch.ones(2)}, v={"x": torch.full((2,), 2.0)},
                                step=torch.tensor(7, dtype=torch.int32)),
        ef_error=None)
    mgr.save(5, state)
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "bfloat16", "int32", "float32", "float32", "float32", "int32"]
    assert np.load(tmp_path / "step_5" / manifest["leaves"][0]["file"]).dtype == np.uint16
    target = tree.map_leaves(torch.zeros_like, state)
    target.params["emb"]["table"].requires_grad_(True)
    out = mgr.restore(5, target, device="cpu")
    assert isinstance(out, ttrainer.TrainState) and isinstance(out.opt_state, topt.OptState)
    assert out.ef_error is None and isinstance(out.params["blocks"], list)
    assert torch.equal(out.params["blocks"][0]["w"].view(torch.int16), bits)
    assert out.params["emb"]["table"].requires_grad
    assert not out.opt_state.m["x"].requires_grad
    for a, b in zip(tree.leaves(out), tree.leaves(state)):
        assert a.dtype == b.dtype
        assert torch.equal(a.detach().reshape(-1).view(torch.uint8),
                           b.detach().reshape(-1).view(torch.uint8))


def test_train_resume_bit_identical(tmp_path):
    """ckpt+restart at step k equals an uninterrupted run (state and data order)."""
    cfg = _cfg()
    run = _run_cfg(microbatches=1, remat="none")
    step_fn = ttrainer.make_train_step(cfg, run)

    def batches(start):
        return DataIterator(cfg, batch=4, seq=16, start_step=start)

    def to_t(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    s_a = ttrainer.init_state(cfg, run, 0, device="cpu")
    it = batches(0)
    for _ in range(6):
        s_a, _ = step_fn(s_a, to_t(next(it)))

    s_b = ttrainer.init_state(cfg, run, 0, device="cpu")
    it = batches(0)
    for _ in range(3):
        s_b, _ = step_fn(s_b, to_t(next(it)))
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, s_b)
    fresh = ttrainer.init_state(cfg, run, 1, device="cpu")   # other weights: all overwritten
    _, s_b2 = mgr.restore_latest(fresh)
    assert int(s_b2.opt_state.step) == 3
    it2 = batches(3)                       # stateless data resume
    for _ in range(3):
        s_b2, _ = step_fn(s_b2, to_t(next(it2)))

    for a, b in zip(tree.leaves(s_a), tree.leaves(s_b2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)


def test_hybrid_train_state_saves_and_resumes(tmp_path):
    """A zamba2 train state (nested lists of Mamba2 layers, one shared block)
    saved after 2 steps and restored into other weights resumes as an
    uninterrupted run, and crosses the JAX layout and back unchanged."""
    cfg = tregistry.get("zamba2-7b").reduced()
    run = _run_cfg(remat="full")
    step_fn = ttrainer.make_train_step(cfg, run)
    data = DataIterator(cfg, batch=2, seq=16)
    batches = [{k: torch.from_numpy(v) for k, v in next(data).items()} for _ in range(4)]

    s_a = ttrainer.init_state(cfg, run, 0, device="cpu")
    for b in batches:
        s_a, _ = step_fn(s_a, b)
    s_b = ttrainer.init_state(cfg, run, 0, device="cpu")
    for b in batches[:2]:
        s_b, _ = step_fn(s_b, b)
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(2, s_b)
    _, s_b2 = mgr.restore_latest(ttrainer.init_state(cfg, run, 1, device="cpu"))
    assert int(s_b2.opt_state.step) == 2
    again = compat.train_state_from_jax(cfg, compat.train_state_to_jax(cfg, s_b2),
                                        device="cpu")
    for a, b in zip(tree.leaves(again), tree.leaves(s_b2)):
        assert torch.equal(a.detach(), b.detach())
    for b in batches[2:]:
        again, _ = step_fn(again, b)
    for a, b in zip(tree.leaves(s_a), tree.leaves(again)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# hand-over of a train state
# ---------------------------------------------------------------------------

def test_train_state_round_trips_through_the_jax_layout():
    cj, ct = jregistry.get("minicpm-2b").reduced(), tregistry.get("minicpm-2b").reduced()
    run = _run_cfg(remat="none", grad_compress="int8")
    state = ttrainer.init_state(ct, run, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(DataIterator(ct, batch=2, seq=8)).items()}
    state, _ = ttrainer.make_train_step(ct, run)(state, batch)   # nonzero m, v, ef, step 1

    back = compat.train_state_to_jax(ct, state)
    want = jax.eval_shape(lambda: jtrainer.init_state(
        cj, jtrainer.RunConfig(grad_compress="int8"), jax.random.PRNGKey(0)))
    jstate = jtrainer.TrainState(back.params, jopt.OptState(*back.opt_state), back.ef_error)
    assert jax.tree.structure(jstate) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert int(back.opt_state.step) == 1

    again = compat.train_state_from_jax(ct, jax.tree.map(np.asarray, jstate), device="cpu")
    assert all(p.requires_grad for p in tree.leaves(again.params))
    assert again.opt_state.step.dtype == torch.int32
    for a, b in zip(tree.leaves(again), tree.leaves(state)):
        assert torch.equal(a.detach(), b.detach())
    off = compat.train_state_to_jax(ct, state._replace(ef_error=None))
    assert off.ef_error is None
    assert compat.train_state_from_jax(ct, off, device="cpu").ef_error is None


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + args, cwd=ROOT,
        timeout=timeout, capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin:/usr/local/bin"})


def test_train_launcher_checkpoints_and_resumes(tmp_path):
    common = ["--device", "cpu", "--arch", "minicpm-2b", "--reduced", "--batch", "4",
              "--seq", "32", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path / "ck")]
    r = _launch(common + ["--steps", "6"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 6 steps" in r.stdout
    assert "SimFA-H800 attention prediction:" in r.stdout
    assert r.stdout.count("\nstep ") == 6
    r2 = _launch(common + ["--steps", "8"])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "[restart] resumed from step 6" in r2.stdout
    assert "step    7 " in r2.stdout and "done: 8 steps" in r2.stdout
    assert CheckpointManager(tmp_path / "ck").all_steps() == [6, 8]


def test_train_launcher_saves_on_sigterm(tmp_path):
    """Preemption: SIGTERM during a run publishes a checkpoint, then exit code 17."""
    ck = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
         "olmo-1b", "--reduced", "--batch", "2", "--seq", "16", "--steps", "100000",
         "--ckpt-every", "100000", "--ckpt-dir", str(ck)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin:/usr/local/bin"})
    try:
        for line in proc.stdout:
            if line.startswith("step    2 "):
                break
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 17, err[-2000:]
    assert "[preempt] checkpoint published; exiting" in out
    steps = CheckpointManager(ck).all_steps()
    assert len(steps) == 1 and 2 <= steps[0] < 100000


@pytest.mark.parametrize("arch", ["dbrx-132b", "pixtral-12b", "rwkv6-7b", "whisper-large-v3"])
def test_train_launcher_trains_moe_and_vlm(arch, tmp_path, capsys):
    handler = signal.getsignal(signal.SIGTERM)       # the launcher installs its own
    try:
        assert tlaunch.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
                             "--seq", "16", "--steps", "2",
                             "--ckpt-dir", str(tmp_path / "ck")]) == 0
    finally:
        signal.signal(signal.SIGTERM, handler)
    out = capsys.readouterr().out
    assert f"arch {arch}-reduced" in out and "done: 2 steps" in out
    assert out.count("\nstep ") == 2
    assert CheckpointManager(tmp_path / "ck").all_steps() == [2]


def test_train_launcher_prediction_line():
    cfg = tregistry.get("olmo-1b")
    line = tlaunch.attention_prediction(cfg, 4, 512)
    assert line.startswith("SimFA-H800 attention prediction: ")
    assert "us/layer" in line and "-bound)" in line


class _Iterator:
    """The launcher's ``DataIterator``, which also records the SIGTERM handler
    in force while the run takes its batches, and on its first batch sends the
    process SIGTERM ("preempted") or raises ("raises")."""
    seen = []

    def __init__(self, how, *args, **kwargs):
        self.how, self.it = how, DataIterator(*args, **kwargs)

    def __next__(self):
        _Iterator.seen.append(signal.getsignal(signal.SIGTERM))
        if self.how == "raises":
            raise RuntimeError("a batch failed")
        if self.how == "preempted":
            os.kill(os.getpid(), signal.SIGTERM)
        return next(self.it)


@pytest.mark.parametrize("how,rc", [("ok", 0), ("preempted", 17), ("raises", None)])
def test_train_launcher_puts_the_sigterm_handler_back(how, rc, tmp_path, monkeypatch):
    """``main`` installs a flag-only SIGTERM handler for its run and puts back
    the one it found on every way out: return 0, return 17 after a SIGTERM,
    and an exception (ROADMAP C31)."""
    def before(*_):
        raise AssertionError("the handler main found was called")

    monkeypatch.setattr(tlaunch, "DataIterator", lambda *a, **k: _Iterator(how, *a, **k))
    _Iterator.seen.clear()
    old = signal.signal(signal.SIGTERM, before)
    try:
        argv = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                "--ckpt-dir", str(tmp_path / "ck")]
        if rc is None:
            with pytest.raises(RuntimeError, match="a batch failed"):
                tlaunch.main(argv)
        else:
            assert tlaunch.main(argv) == rc
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, old)
    assert _Iterator.seen and all(h not in (before, old) and callable(h) for h in _Iterator.seen)


def test_train_launcher_refuses_what_the_port_lacks():
    # --dp 2 in a process group of one rank: the mesh's named error
    with pytest.raises(MeshSizeError, match="needs 2 rank"):
        tlaunch.main(["--device", "cpu", "--dp", "2"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.init_state(_cfg(), _run_cfg(), 0)
