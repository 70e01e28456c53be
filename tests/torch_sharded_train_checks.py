"""The sharded training jobs on 3 or 4 gloo ranks and the checks that read
them, shared by two test files: ``tests/test_torch_parallel.py`` runs the jobs
with the residual whole, ``tests/test_torch_parallel_seq.py`` the "-sp" jobs,
whose residual is split by sequence over ``model`` (sequence parallelism).
Each file imports the three ``test_*`` checks below, and pytest collects them
there over that file's own module-scoped ``sharded_run`` fixture, whose value
``run_job`` gives. The rank runner ``_run_ranks`` and the single-device run
``_single_device`` serve ``tests/test_torch_parallel_families.py`` and
``tests/test_torch_ckpt_jax.py`` too.

The multi-rank runs start their ranks as subprocesses on a ``file://`` store
under ``tmp_path``, each with its own timeout; they train in fp32 compute at
the launcher's learning-rate schedule (ROADMAP C26: in bf16, each data rank
rounds its partial weight gradients before the sum), but for the bf16 jobs
held at a tolerance measured on them.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.data.synthetic import DataIterator
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 300           # seconds a multi-rank run may take
TOL = 1e-5                   # sharded (2 x 2) against single-device, relative / absolute


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


# the rank worker (``tests/torch_sharded_worker.py``): each rank asserts its
# local shapes against the specs and the partitioned route, and records what
# the checks below read
WORKER = Path(__file__).resolve().parent / "torch_sharded_worker.py"


def _run_ranks(tmp_path, job, n=4):
    """Runs ``WORKER`` on ``n`` gloo ranks; returns rank 0's output."""
    job = dict(job, store=str(tmp_path / "store"), out=str(tmp_path / "out"),
               ckpt=str(tmp_path / "ckpt"))
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
        out = json.load(f)
    out["params"] = list(np.load(job["out"] + ".npz").values())
    return out


def _single_device(arch, batch, seq, steps, microbatches, replace=None, moe_groups=None):
    """The same steps on one device: (metrics, parameters); each MoE layer's
    routing groups appended to ``moe_groups`` where given (the worker's
    ``Recorder``)."""
    from torch_sharded_worker import Recorder
    cfg = dataclasses.replace(tregistry.get(arch).reduced(),
                              **{"compute_dtype": "float32", **(replace or {})})
    run = ttrainer.RunConfig(microbatches=microbatches, opt=topt.OptConfig(
        lr=3e-4, warmup_steps=10, total_steps=steps, schedule=cfg.lr_schedule))
    state = ttrainer.init_state(cfg, run, 0, device="cpu")
    step = ttrainer.make_train_step(cfg, run)
    data = DataIterator(cfg, batch=batch, seq=seq)
    metrics = []
    with Recorder(cfg) as rec:
        for _ in range(steps):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in next(data).items()})
            metrics.append({k: float(v) for k, v in m.items()})
    if moe_groups is not None:
        moe_groups.extend(rec.groups)
    return metrics, [p.detach().numpy() for p in tree.leaves(state.params)]


# olmo: 2 microbatches a rank; dbrx: each data rank's 2 x 256 rows make one MoE
# dispatch group, its 4 experts 2 a model rank (EP); qwen on a (1, 4) mesh: one
# q head a rank, and GQA with QKV bias whose wk / wv shard would be half a kv
# head (gathered over model for compute); grok with 2 experts on (1, 4): TP
# within the experts (each rank a quarter of every expert's d_ff and output
# columns), the scatter dispatch too. On (1, 3), where 3 divides some dims
# and not others: qwen with 12 / 4 heads (4 q heads a rank, the kv heads
# whole, rank 0's q heads on kv heads 0, 0, 0, 1), d_ff 96 split, d_model 64
# and the vocabulary 256 whole (wd and wo on all their columns on every
# rank); grok with 2 experts and d_ff 96: the attention whole (4 heads), TP
# within the experts with wd on all its columns. grok in bf16 compute on
# (1, 4): the partitioned products' and sums' roundings (each input's gradient
# summed in fp32 over the ranks and rounded once, where one device rounds each
# product's), at ``tol``: its largest relative differences from one device
# were 3.1e-4 on the gradient norms, 1.4e-5 on the losses, none on the first
# loss, and its largest parameter difference 1.8e-4 (3 Adam steps at lr <=
# 3e-5 bound that last one whatever the gradients), so 1e-3.
# The "-sp" jobs run each step inside a train cell's activation scope, whose
# residual spec ("data", "model", None) splits the residual by sequence over
# model (sequence parallelism) where tp divides the sequence: olmo in 2
# microbatches on 2 x 2; qwen on (1, 3) at 18 positions and at 16, which 3
# does not divide (the residual whole); dbrx on 2 x 2, each data rank's
# 2 x 256 rows one dispatch group, gathered from its model ranks' rows; grok
# on (1, 4), TP within the experts, and its bf16 job; pixtral (vlm) on 2 x 2,
# its 8-position prefix and 16 tokens split 12 / 12.
SP = ["data", "model", None]
JOBS = {"olmo-1b": dict(arch="olmo-1b", mesh=[2, 2], batch=8, seq=16, steps=3,
                        microbatches=2),
        "dbrx-132b": dict(arch="dbrx-132b", mesh=[2, 2], batch=4, seq=256, steps=3,
                          microbatches=1),
        "qwen2.5-3b": dict(arch="qwen2.5-3b", mesh=[1, 4], batch=4, seq=16, steps=3,
                           microbatches=1),
        "grok-1-314b": dict(arch="grok-1-314b", mesh=[1, 4], batch=4, seq=256, steps=3,
                            microbatches=1, replace={"num_experts": 2}),
        "qwen2.5-3b-tp3": dict(arch="qwen2.5-3b", mesh=[1, 3], batch=4, seq=16, steps=3,
                               microbatches=1,
                               replace={"num_heads": 12, "num_kv_heads": 4, "d_ff": 96}),
        "grok-1-314b-tp3": dict(arch="grok-1-314b", mesh=[1, 3], batch=4, seq=256, steps=3,
                                microbatches=1, replace={"num_experts": 2, "d_ff": 96}),
        "grok-1-314b-bf16": dict(arch="grok-1-314b", mesh=[1, 4], batch=4, seq=256, steps=3,
                                 microbatches=1, tol=1e-3,
                                 replace={"num_experts": 2, "compute_dtype": "bfloat16"}),
        "olmo-1b-sp": dict(arch="olmo-1b", mesh=[2, 2], batch=8, seq=16, steps=3,
                           microbatches=2, residual=SP),
        "qwen2.5-3b-tp3-sp": dict(arch="qwen2.5-3b", mesh=[1, 3], batch=4, seq=18, steps=3,
                                  microbatches=1, residual=SP,
                                  replace={"num_heads": 12, "num_kv_heads": 4, "d_ff": 96}),
        "qwen2.5-3b-tp3-sp16": dict(arch="qwen2.5-3b", mesh=[1, 3], batch=4, seq=16, steps=3,
                                    microbatches=1, residual=SP,
                                    replace={"num_heads": 12, "num_kv_heads": 4, "d_ff": 96}),
        "dbrx-132b-sp": dict(arch="dbrx-132b", mesh=[2, 2], batch=4, seq=256, steps=3,
                             microbatches=1, residual=SP),
        "grok-1-314b-sp": dict(arch="grok-1-314b", mesh=[1, 4], batch=4, seq=256, steps=3,
                               microbatches=1, residual=SP, replace={"num_experts": 2}),
        "grok-1-314b-bf16-sp": dict(arch="grok-1-314b", mesh=[1, 4], batch=4, seq=256,
                                    steps=3, microbatches=1, tol=1e-3, residual=SP,
                                    replace={"num_experts": 2, "compute_dtype": "bfloat16"}),
        "pixtral-12b-sp": dict(arch="pixtral-12b", mesh=[2, 2], batch=4, seq=16, steps=3,
                               microbatches=1, residual=SP)}


def run_job(name, tmp_path_factory):
    """The ``sharded_run`` fixture's value for job ``name``: (name, rank 0's
    output, the single-device run's (metrics, parameters)); rank 0's output
    also holds the single-device run's MoE groups."""
    job = JOBS[name]
    out = _run_ranks(tmp_path_factory.mktemp(name), job, n=int(np.prod(job["mesh"])))
    out["one_device_moe_groups"] = []
    want = _single_device(job["arch"], job["batch"], job["seq"], job["steps"],
                          job["microbatches"], job.get("replace"),
                          moe_groups=out["one_device_moe_groups"])
    return name, out, want


def test_sharded_training_matches_the_single_device_run(sharded_run):
    """Losses, MoE aux, global gradient norms and the gathered parameters of 3
    partitioned steps on a 2 x 2, 1 x 4 or 1 x 3 mesh within 1e-5 of one
    device (the bf16 job within its measured ``tol``; olmo in 2 microbatches
    on both: a rank's microbatch i holds its share of the global microbatch
    i)."""
    name, out, (metrics, params) = sharded_run
    tol = JOBS[name].get("tol", TOL)
    for got, want in zip(out["metrics"], metrics):
        for k in ("loss", "aux", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=tol, abs=tol), (name, k, got, want)
    assert len(out["params"]) == len(params)
    for got, want in zip(out["params"], params):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_sharded_run_checks_its_own_invariants(sharded_run):
    """The worker asserted each rank's local shapes against the specs and the
    partitioned route; the dense runs also the DTensor constrain and the
    elastic restore under 4 x 1; the moe run over two data ranks refuses a
    rank's rows short of a dispatch group (ROADMAP C27), with grad and
    without (only the serving scope gathers a group over data); over one data rank
    the moe run's scatter dispatch is held to one device's. The inputs'
    gradients are summed over model: all-reduced (``all_reduce_f32``) in the
    runs with the residual whole, reduce-scattered back to the rows
    (``seq_gather_f32``) where it is split by sequence."""
    name, out, _ = sharded_run
    tol = JOBS[name].get("tol", TOL)
    if out["seq_parallel"]:
        assert out["seq_scatters"] > 0
    else:
        assert out["model_reduces"] > 0 and out["seq_scatters"] == 0
    if JOBS[name]["arch"] == "dbrx-132b":
        assert "fewer than a group of 512" in out["moe_small_batch"]
        assert "fewer than a group of 512" in out["moe_small_batch_no_grad"]
    elif JOBS[name]["arch"] == "grok-1-314b":
        assert out["scatter_loss"] == pytest.approx(out["scatter_loss_one"], rel=tol, abs=tol)
    else:
        # the 4-rank dense runs restore under 4 x 1
        assert out.get("elastic") == ("ok" if np.prod(JOBS[name]["mesh"]) == 4 else None)


def test_the_residual_is_split_by_sequence_where_tp_divides_it(sharded_run):
    """Under a train cell's residual spec (the "-sp" jobs) each block's input
    is the model rank's ``S/tp`` rows (``S`` the tokens behind a VLM's prefix)
    where ``trainer.seq_parallel`` holds, and whole elsewhere and in the jobs
    without the spec; no all-reduce of a 2-d or larger tensor is issued in
    the forward of a split run (no sum of per-rank partial products, C32: its
    sums over model are reduce-scatters of fp32 gradients). Every MoE job's
    routing is one device's: data rank 0's first dispatch group holds one
    device's first group's tokens, with its capacity and its dropped choices,
    at every MoE layer's call (the forwards and the remat recomputes)."""
    name, out, _ = sharded_run
    job = JOBS[name]
    cfg = tregistry.get(job["arch"]).reduced()
    S = job["seq"] + (cfg.frontend_len if cfg.family == "vlm" else 0)
    tp = job["mesh"][1]
    split = "residual" in job and S % tp == 0
    assert out["seq_parallel"] == split
    assert out["block_rows"] == [S // tp if split else S]
    if split:
        assert out["forward_reduces"] == []
    if cfg.family == "moe":
        one = out["one_device_moe_groups"]
        assert len(out["moe_groups"]) == len(one) == 2 * cfg.num_layers * job["steps"]
        for (t, g, dropped), (t1, g1, dropped1) in zip(out["moe_groups"], one):
            assert (g, dropped) == (g1, dropped1) and t == t1 // job["mesh"][0]
