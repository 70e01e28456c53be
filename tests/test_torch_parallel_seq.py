"""Sharded training with the residual split by sequence over ``model``
(sequence parallelism): the seven "-sp" jobs on 3 or 4 gloo ranks,
each step run inside a train cell's activation scope, whose residual spec
``("data", "model", None)`` splits the residual where tp divides the
sequence, held to the single-device port run (``TOL``; the bf16 job at its
measured ``tol``).

The jobs and the three checks that read them live in
``tests/torch_sharded_train_checks.py``, shared with
``tests/test_torch_parallel.py``, which runs the jobs with the residual
whole; this file runs the same checks over the "-sp" jobs in a file of its
own, so that ``--dist loadfile`` hands the two halves to two workers.
"""
import dataclasses

import pytest

from repro_torch.configs import registry as tregistry
from repro_torch.parallel import sharding as tshd
from torch_sharded_train_checks import (  # noqa: F401  (the checks run here)
    JOBS, run_job, test_sharded_run_checks_its_own_invariants,
    test_sharded_training_matches_the_single_device_run,
    test_the_residual_is_split_by_sequence_where_tp_divides_it)

SP_JOBS = [n for n, j in JOBS.items() if "residual" in j]


@pytest.fixture(scope="module", params=SP_JOBS)
def sharded_run(request, tmp_path_factory):
    return run_job(request.param, tmp_path_factory)


def test_the_sp_jobs_split_what_their_names_say():
    """The "-sp" jobs' layouts: dbrx under EP, grok TP within its experts, qwen
    at tp 3 splitting its q heads and ``d_ff`` but not ``d_model``."""
    def lay(name):
        job = JOBS[name]
        cfg = dataclasses.replace(tregistry.get(job["arch"]).reduced(), **job.get("replace", {}))
        return tshd.model_layout(cfg, job["mesh"][1])

    assert lay("dbrx-132b-sp").experts == "ep" and lay("grok-1-314b-sp").experts == "tp"
    tp3 = lay("qwen2.5-3b-tp3-sp")
    assert tp3.heads and not tp3.kv_heads and tp3.d_ff and not tp3.d_model and not tp3.vocab
    assert len(SP_JOBS) == 7
