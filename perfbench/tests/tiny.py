"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files with every width made small, for the tests."""
from __future__ import annotations

import copy
from typing import Optional

import torch

from perfbench import bench, harness

SMALL = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 256}
PORT = {"d_model": 64, "d_ff": 128, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
        "num_layers": 2, "vocab_size": 256}
TRAFFIC = {
    "command-r-plus-104b-l8.chat_1k_256": {"clients": 4, "prompt_len": 16, "max_new": 6,
                                           "max_seq": 22, "check_requests": 3,
                                           "trace": {"decode_ticks": 2, "skip": 1}},
    "command-r-plus-104b-l8.rag_4k": {"clients": 2, "prompt_len": 24, "max_new": 3,
                                      "max_seq": 27, "check_requests": 2},
    "olmo-1b.pretrain_8x2k": {"batch": 4, "seq": 16, "feed_steps": 8},
}
SEED = 2 ** 31 + 12345


def ctx(cell: str, *, seed: int = SEED, seconds: float = 0.5, trace: bool = False,
        fault: Optional[str] = None, control: bool = False, limits=None) -> harness.Ctx:
    b = bench.benchmark()
    c = harness.Ctx.of_cell(cell, seed, seconds, trace, "cpu", bench_json=b,
                            fault=fault, control=control)
    c.conf = copy.deepcopy(c.conf)
    c.conf.update(SMALL)
    c.conf["port"] = {**c.conf.get("port", {}), **PORT}
    c.traffic = {**copy.deepcopy(c.traffic), **TRAFFIC[cell]}
    if limits is not None:
        c.limits = limits
    c.device = torch.device("cpu")
    return c
