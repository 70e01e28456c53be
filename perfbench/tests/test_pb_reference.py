"""The plain reference against the port, at small sizes on the CPU: serving
through the engine's semantics, and three training steps."""
import copy

import numpy as np
import pytest
import torch

from perfbench import port, synthetic, weights
from perfbench.reference import dense_lm
from perfbench.tests import tiny

CELLS = {"command-r-plus-104b-l8": "command-r-plus-104b-l8.chat_1k_256",
         "olmo-1b": "olmo-1b.pretrain_8x2k"}


def small_conf(config, dtype="float32"):
    c = tiny.ctx(CELLS[config])
    conf = copy.deepcopy(c.conf)
    conf["torch_dtype"] = dtype
    conf["port"] = dict(conf["port"], compute_dtype=dtype)
    return conf, c


@pytest.mark.parametrize("config", sorted(CELLS))
def test_served_logits_follow_the_engine(config):
    """The port's prefill and decode steps (the prompt's last token fed again,
    then each greedy token) against the reference's forward over the
    sequence the engine decoded, float32 compute."""
    from repro_torch.models import api
    conf, _ = small_conf(config)
    cfg = port.config(conf)
    params = weights.draw(api.init(cfg, device="meta"), tiny.SEED, "cpu")
    prompt = torch.from_numpy(synthetic.tokens(tiny.SEED, 3, 1, 12, cfg.vocab_size))
    with torch.no_grad():
        _, cache = api.prefill(cfg, params, {"tokens": prompt}, max_seq=20)
        tok, got, served = prompt[:, -1:], [], []
        for _ in range(6):
            lg, cache = api.decode(cfg, params, cache, tok)
            got.append(lg[0, -1].float())
            tok = lg[:, -1:].argmax(-1).to(torch.int32)
            served.append(int(tok))
    seq = torch.tensor(prompt[0].tolist() + [int(prompt[0, -1])] + served[:-1])
    want = dense_lm.logits(conf, params, seq)[12:]
    torch.testing.assert_close(torch.stack(got), want, atol=2e-4, rtol=2e-4)
    gaps = dense_lm.served_gaps(conf, params, [(prompt[0].tolist(), served)], vocab_rows=100)
    assert max(gaps["gaps"][0]) < 1e-4


def test_served_gaps_catch_a_wrong_token():
    from repro_torch.models import api
    conf, _ = small_conf("command-r-plus-104b-l8")
    cfg = port.config(conf)
    params = weights.draw(api.init(cfg, device="meta"), tiny.SEED, "cpu")
    prompt = synthetic.tokens(tiny.SEED, 4, 1, 10, cfg.vocab_size)[0].tolist()
    seq = torch.tensor(prompt + [prompt[-1]])
    best = int(dense_lm.logits(conf, params, seq)[-1].argmax())
    good = dense_lm.served_gaps(conf, params, [(prompt, [best])])
    bad = dense_lm.served_gaps(conf, params, [(prompt, [(best + 1) % cfg.vocab_size])],
                               control=True)
    assert good["gaps"][0][0] == 0.0 and bad["gaps"][0][0] > 0.0
    assert len(bad["control_gaps"][0]) == 1


def test_three_training_steps_follow_the_trainer():
    """The reference's three AdamW steps against the port's trainer from the
    same weights and batches, float32 compute (the trainer's logits product
    takes bf16 operands, so the two differ by that rounding)."""
    from repro_torch.models import api
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    conf, c = small_conf("olmo-1b")
    t = c.traffic
    cfg = port.config(conf)
    run = trainer.RunConfig(remat="full", opt=opt.OptConfig(**t["optimizer"]))
    layout = api.init(cfg, device="meta")
    params = weights.draw(layout, tiny.SEED, "cpu", requires_grad=True)
    state = trainer.TrainState(params, opt.init(params), None)
    step = trainer.make_train_step(cfg, run)
    batches = [synthetic.train_batch(tiny.SEED, i, t["batch"], t["seq"], cfg.vocab_size)
               for i in range(3)]
    losses, first = [], None
    for i, (tok, lab) in enumerate(batches):
        state, m = step(state, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})
        losses.append(float(m["loss"]))
        if i == 0:
            first = [float(x.norm()) / 0.1 for _, x in weights.leaves_with_paths(state.opt_state.m)]
    p0 = weights.draw(layout, tiny.SEED, "cpu")
    change = [float((a.detach() - b).norm()) for (_, a), (_, b) in
              zip(weights.leaves_with_paths(state.params), weights.leaves_with_paths(p0))]
    ref = dense_lm.train_steps(conf, weights.draw(layout, tiny.SEED, "cpu"),
                               [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in batches],
                               {**t["optimizer"]})
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-3)
    np.testing.assert_allclose(first, list(ref["first_grad_norms"].values()), rtol=2e-3)
    np.testing.assert_allclose(change, list(ref["change_norms"].values()), rtol=2e-3)
