"""Quickstart of the PyTorch/CUDA port: the three faces of the framework, as
``examples/quickstart.py`` shows them for the JAX package.

  1. train a tiny LM a few steps (model zoo + trainer substrate),
  2. decode from it with the serving engine (batched requests): the port's
     main path, through its hand-written attention kernels on the card,
  3. predict an H800 FlashAttention-3 kernel's latency with the Sim-FA
     cycle simulator and SimFA-python analytical model (the port's copy).

    PYTHONPATH=src python examples/torch_quickstart.py                 # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # plain PyTorch

``--device`` defaults to ``cuda`` and a missing card is an error.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.llama3 import workload
from repro_torch.core import analytical
from repro_torch.core.machine import H800
from repro_torch.core.simfa import simulate_fa3
from repro_torch.data.synthetic import DataIterator
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import trainer
from repro_torch.train.optimizer import OptConfig


def main(argv=None):
    """Runs the three steps; returns the serving step's numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = api.resolve_device(args.device)

    # ------------------------------------------------------ 1. train
    cfg = registry.get("olmo-1b").reduced()
    print(f"[1/3] training {cfg.name} ({cfg.num_layers}L d={cfg.d_model}) on {device} ...")
    run = trainer.RunConfig(microbatches=1, remat="none",
                            opt=OptConfig(lr=3e-3, warmup_steps=5))
    state = trainer.init_state(cfg, run, args.seed, device=device)
    step_fn = trainer.make_train_step(cfg, run)
    data = DataIterator(cfg, batch=8, seq=32)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for _, b in zip(range(8), data)]
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        print(f"    step {i}: loss={losses[-1]:.4f}")
    # the loss of step 0's batch, before and after the 8 steps: the tokens are
    # uniform noise, so two batches' losses differ by more than 8 steps move
    # them, and the last step's loss against the first's would read the noise
    with torch.no_grad():
        after = float(trainer.make_loss_fn(cfg, run)(state.params, batches[0])[1]["loss"])
    print(f"    step 0's batch after training: loss={after:.4f}")
    if not after < losses[0]:
        raise AssertionError(f"loss should decrease: {losses[0]:.4f} -> {after:.4f}")

    # ------------------------------------------------------ 2. serve
    print("[2/3] serving 6 batched requests ...")
    eng = ServeEngine(cfg, state.params, slots=3, max_seq=64, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8),
                    max_new=4) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    for r in reqs:
        print(f"    req {r.rid}: {r.out}")
    if not all(len(r.out) == 4 for r in reqs):
        raise AssertionError(f"every request should get 4 tokens: {[r.out for r in reqs]}")

    # ------------------------------------------------------ 3. simulate
    print("[3/3] Sim-FA: llama3-8B attention @ seq 1024 on H800 ...")
    w = workload("8B", 1024, batch=1)
    sim = simulate_fa3(w, H800, fidelity="auto")
    rep = analytical.analyze(w, H800)
    print(f"    cycle-sim latency : {sim.latency_us:9.1f} us "
          f"(fidelity={sim.fidelity}, tensor-core util {sim.tc_util:.0%})")
    print(f"    analytical latency: {rep.latency*1e6:9.1f} us "
          f"(bottleneck: {rep.bottleneck})")
    print(f"    L2 traffic        : sim {sim.l2_bytes/1e6:.1f} MB vs "
          f"Eq.(2) {rep.l2_bytes/1e6:.1f} MB")
    print(f"    DRAM traffic      : sim {sim.dram_bytes/1e6:.1f} MB vs "
          f"model {rep.dram_bytes/1e6:.1f} MB "
          f"({'ideal' if rep.ideal_regime else 'realistic'} regime, "
          f"{rep.waves_per_group} wave(s))")
    print("quickstart OK")
    toks = sum(len(r.out) for r in reqs)
    return {"losses": losses, "loss_after": after, "serve_tokens": toks, "serve_seconds": dt,
            "tokens_per_s": toks / dt}


if __name__ == "__main__":
    main()
