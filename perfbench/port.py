"""What the drivers take from the program: its configuration of a model,
checked against the configuration file the cell names."""
from __future__ import annotations

import dataclasses
from typing import Dict

NORMS = {"layernorm": "layernorm", "nonparametric": "nonparam_ln"}


def config(conf: Dict):
    """The port's ``ModelConfig`` of the registry entry ``conf["registry"]``
    with ``conf["port"]``'s fields replaced, after checking that every size
    the file states is the one the port will run."""
    from repro_torch.configs import registry

    cfg = dataclasses.replace(registry.get(conf["registry"]), **conf.get("port", {}))
    want = {"d_model": conf["hidden_size"], "num_heads": conf["num_attention_heads"],
            "num_kv_heads": conf["num_key_value_heads"], "head_dim": conf["head_dim"],
            "d_ff": conf["intermediate_size"], "vocab_size": conf["vocab_size"],
            "num_layers": conf["num_hidden_layers"], "rope_theta": conf["rope_theta"],
            "tie_embeddings": conf["tie_word_embeddings"], "compute_dtype": conf["torch_dtype"],
            "norm": NORMS[conf["norm"]], "mlp": "swiglu", "family": "dense",
            "bias": conf["attention_bias"], "qkv_bias": conf["attention_bias"]}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"{conf['name']}: the port's configuration differs from the file's "
                         f"(port, file): {diff}")
    return cfg
