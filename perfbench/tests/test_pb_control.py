"""The control: the reference in float8 put in the program's place. At a
small size on the CPU it reads above the program; on the card, at the
cells' own sizes, above each cell's limit (``gpu``: run there with
``python -m pytest -m gpu perfbench/tests/test_pb_control.py``)."""
import pytest
import torch

from perfbench import harness, port, synthetic, weights
from perfbench.reference import dense_lm
from perfbench.tests import tiny

SEEDS = (2147483659, 2147483693, 2147483713)
# windows that finish a cell's longest requests (a chat wave takes ~5-6 s)
WINDOW_S = {"command-r-plus-104b-l8.chat_1k_256": 8.0, "command-r-plus-104b-l8.rag_4k": 3.0,
            "olmo-1b.pretrain_8x2k": 2.0}


def test_serving_control_puts_other_tokens_first_on_the_cpu():
    """Over the reference's own greedy tokens (gap 0 each), the float8
    control puts another token first somewhere."""
    from repro_torch.models import api
    c = tiny.ctx("command-r-plus-104b-l8.chat_1k_256")
    cfg = port.config(c.conf)
    params = weights.draw(api.cast_params(cfg, api.init(cfg, device="meta")), tiny.SEED, "cpu")
    requests = []
    for rid in range(8):
        prompt = synthetic.tokens(tiny.SEED, rid, 1, 16, cfg.vocab_size)[0].tolist()
        seq, out = prompt + [prompt[-1]], []
        for _ in range(8):
            out.append(int(dense_lm.logits(c.conf, params, torch.tensor(seq))[-1].argmax()))
            seq.append(out[-1])
        requests.append((prompt, out))
    got = dense_lm.served_gaps(c.conf, params, requests, control=True)
    assert max(max(g) for g in got["gaps"]) == 0.0
    assert max(max(g) for g in got["control_gaps"]) > 0.0


def test_training_control_reads_above_the_program_on_the_cpu():
    out = harness.run(tiny.ctx("olmo-1b.pretrain_8x2k", seconds=0.5, control=True))
    r = out["readings"]
    for name in ("first_grad_gap", "change_gap"):
        assert r["control_" + name] > 2 * out["checks"][name]["value"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["command-r-plus-104b-l8.chat_1k_256",
                                  "command-r-plus-104b-l8.rag_4k", "olmo-1b.pretrain_8x2k"])
def test_control_fails_the_limit_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    for seed in SEEDS:
        out = harness.run(harness.Ctx.of_cell(cell, seed, WINDOW_S[cell], False, "cuda",
                                              control=True))
        r = out["readings"]
        assert any(r["control_" + k] > c["limit"] for k, c in out["checks"].items()
                   if "control_" + k in r), (seed, r, out["checks"])
        torch.cuda.empty_cache()
