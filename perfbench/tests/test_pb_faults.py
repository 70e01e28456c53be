"""A run of each cell, the look for a chip skipped, at a small size on the
CPU, with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have, against the cell's own limits, where a sound
run reads far below them."""
import pytest

from perfbench import harness
from perfbench.tests import tiny

FAULTS = [
    ("command-r-plus-104b-l8.chat_1k_256", "token_altered"),
    ("command-r-plus-104b-l8.rag_4k", "token_altered"),
    ("olmo-1b.pretrain_8x2k", "state_unchanged"),
    ("olmo-1b.pretrain_8x2k", "half_batch"),
]


def _run(cell, **kw):
    out = harness.run(tiny.ctx(cell, seconds=1.5, **kw))
    return out, {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_makes_the_run_incorrect(cell, fault):
    bad, bad_reads = _run(cell, fault=fault)
    assert bad["correct"] is False
    sound, sound_reads = _run(cell)
    assert sound_reads["bad_requests" if "bad_requests" in sound_reads else "nonfinite_steps"] == 0
    # a number that the fault takes past its limit, reading ten times the sound run's
    assert [k for k, v in bad_reads.items()
            if v > bad["checks"][k]["limit"] and v > 10 * sound_reads[k]]


def test_a_sound_serving_run_is_correct():
    out, reads = _run("command-r-plus-104b-l8.chat_1k_256")
    assert out["correct"] is True and reads["logit_gap_max"] < 0.05
    assert out["readings"]["requests_checked"] == 3
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"gen_tok_s"}          # setup_s needs the process's start
    assert list(out)[-1] == "checks"


def test_a_traced_run_reports_per_layer_metrics():
    out = harness.run(tiny.ctx("olmo-1b.pretrain_8x2k", seconds=0.5, trace=True))
    assert "breakdown" in out and out["device"]["window_s"] > 0
    # on the CPU no card metric and no peak exists: only what the host can read
    assert set(out["metrics"]) <= {m["name"] for m in tiny.ctx("olmo-1b.pretrain_8x2k").per_layer}


def test_failed_counts_the_finished_requests_that_did_not_come_back_whole():
    from types import SimpleNamespace as NS
    from perfbench import bench
    drv = bench.driver("serve_engine")
    c = tiny.ctx("command-r-plus-104b-l8.rag_4k")
    n, V = c.traffic["max_new"], c.conf["vocab_size"]
    fl = lambda out, done: NS(req=NS(out=out), done=done)
    flights = [fl([1] * n, 1.0), fl([1] * (n - 1), 1.0), fl([V] * n, 2.0),
               fl([1] * (n - 1), None), fl([1], 9.0)]
    assert drv.counts_of(c, {"flights": flights, "end": 5.0}) == (5, 2)
