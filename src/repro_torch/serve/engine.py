"""Batched serving engine: continuous-batching-lite over prefill / decode
steps, with straggler deadlines.

Slots hold independent requests; finished slots are refilled from the queue
without stopping the decode loop. The engine runs on the card unless the caller
passes ``device="cpu"``.

Requests are token prompts alone, as in the reference, whose engine cannot
serve an encoder-decoder model (its prefill reads ``batch["frames"]``): here
``ServeEngine`` refuses the encdec family with ``NotImplementedError`` at
construction. Such a model is served through ``api.prefill`` / ``api.decode``
with its frames.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import api, transformer
from repro_torch.obs.spans import span
from repro_torch.serve.decode import make_serve_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    # the engine's stamps, ``time.perf_counter()``: submitted, admitted (just
    # before its prefill), its first token appended, marked done
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclass
class StragglerPolicy:
    """Deadline-based step watchdog: steps slower than ``factor`` x the expected
    step time are counted and surfaced (on real fleets: triggers re-dispatch /
    hot-spare swap)."""
    expected_step_s: float = 0.1
    factor: float = 5.0
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        slow = dt > self.factor * self.expected_step_s
        if slow:
            self.slow_steps += 1
        return slow

    @classmethod
    def from_samples(cls, samples, *, percentile: float = 0.99,
                     factor_floor: float = 1.5) -> "StragglerPolicy":
        """Calibrate from a sampled step-time distribution instead of a
        hand-picked factor. Expectation is the sample median; the factor is the
        p-``percentile``/median ratio (floored at ``factor_floor`` so a tight
        distribution still tolerates scheduler noise)."""
        xs = sorted(float(s) for s in samples)
        if not xs:
            return cls()
        med = xs[len(xs) // 2]
        hi = xs[min(len(xs) - 1, int(percentile * (len(xs) - 1)))]
        factor = max(factor_floor, hi / med if med > 0 else factor_floor)
        return cls(expected_step_s=med, factor=factor)


class ServeEngine:
    def __init__(self, cfg, params, *, slots: int = 4, max_seq: int = 256,
                 straggler: Optional[StragglerPolicy] = None, device="cuda",
                 mode=None):
        if cfg.family == "encdec":
            raise NotImplementedError(
                f"ServeEngine serves token prompts and cannot serve the encdec family "
                f"({cfg.name}): its prefill needs the encoder's frames, which a Request "
                "does not carry (as in the reference engine); call api.prefill with "
                "{'tokens', 'frames'} and api.decode instead")
        self.cfg = cfg
        self.device = api.resolve_device(device)
        self.mode = mode
        # weights cast once to the types the forward computes in, and moved to
        # the engine's device; the per-call casts in ``layers.dense`` then cost
        # nothing
        self.params = api.cast_params(cfg, params, device=self.device)
        self.slots = slots
        self.max_seq = max_seq
        self.straggler = straggler or StragglerPolicy()
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.cache = api.init_cache(cfg, slots, max_seq, dtype=cfg.compute_dtype,
                                    device=self.device)
        self.tokens = torch.zeros((slots, 1), dtype=torch.int32, device=self.device)
        self._decode = make_serve_step(cfg, mode=mode)
        self.steps = 0
        self.prompt_len: Optional[int] = None

    def submit(self, req: Request):
        # fixed prompt length per engine instance (scalar cache index);
        # production variant: per-slot index vector + length masking
        if self.prompt_len is None:
            self.prompt_len = len(req.prompt)
        if len(req.prompt) != self.prompt_len:
            raise ValueError("engine instance serves fixed-length prompts: got "
                             f"{len(req.prompt)} tokens, expected {self.prompt_len}")
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    # --------------------------------------------------------------
    @torch.no_grad()
    def _prefill_slot(self, slot: int, req: Request):
        """Single-request prefill into the shared cache (slot-batched)."""
        with span("engine.prefill"):
            toks = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                   device=self.device)[None]
            _, cache1 = api.prefill(self.cfg, self.params, {"tokens": toks},
                                    max_seq=self.max_seq, mode=self.mode)
            transformer.write_slot(self.cfg, self.cache, slot, cache1)
            # as in the reference engine: the engine-wide index follows the newest
            # prompt, and the prompt's last token is fed again as the first decode input
            self.cache["idx"] = cache1["idx"]
            self.tokens[slot, 0] = int(req.prompt[-1])

    def step(self):
        """One engine tick: refill empty slots, run one decode step."""
        with span("engine.tick"):
            for i in range(self.slots):
                if self.active[i] is None and self.queue:
                    req = self.queue.pop(0)
                    req.t_admit = time.perf_counter()
                    self._prefill_slot(i, req)
                    self.active[i] = req
            if all(r is None for r in self.active):
                return False
            t0 = time.perf_counter()
            next_tok, self.cache = self._decode(self.params, self.cache, self.tokens)
            with span("engine.wait"):
                toks = next_tok[:, 0].tolist()          # waits for the step to finish
            self.straggler.observe(time.perf_counter() - t0)
            self.tokens = next_tok
            self.steps += 1
            with span("engine.emit"):
                for i, req in enumerate(self.active):
                    if req is None:
                        continue
                    req.out.append(int(toks[i]))
                    if len(req.out) == 1:
                        req.t_first = time.perf_counter()
                    if len(req.out) >= req.max_new:
                        req.done = True
                        req.t_done = time.perf_counter()
                        self.active[i] = None
            return True

    def run(self, max_steps: int = 10_000) -> List[Request]:
        # as in the reference engine, the returned list stays empty: callers
        # read ``req.out`` of the requests they submitted
        finished: List[Request] = []
        while (self.queue or any(self.active)) and self.steps < max_steps:
            self.step()
        return finished
