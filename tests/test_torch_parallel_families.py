"""The partitioned sharded step of the hybrid (zamba2-7b), ssm (rwkv6-7b) and
encdec (whisper-large-v3) families: their compute layout over ``model`` at
full width (each leaf's spec and gradient kind, ``sharding.compute_layout``),
and 3 training steps on 3 or 4 gloo ranks held to the single-device port run
within ``TOL`` on losses, gradient norms and the gathered parameters.

The jobs run ``test_torch_parallel``'s gloo worker (imported, not copied) on
reduced fp32 configs: each family on a 2 x 2 mesh, where tp 2 divides every
dim it splits, and once on a (1, tp) mesh where tp divides some dims and not
others (``replace=`` where the reduced config would divide everything).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import api as tapi
from repro_torch.parallel import sharding as tshd
from repro_torch.train import trainer as ttrainer
from test_torch_parallel import TOL, FakeMesh, _port_key, _run_ranks, _single_device

FAMILIES = {"zamba2-7b": "hybrid", "rwkv6-7b": "ssm", "whisper-large-v3": "encdec"}


def _segments(*parts):
    """A ``Segments`` entry from (size, split) pairs."""
    return tshd.Segments(tuple(n for n, _ in parts), tuple(s for _, s in parts))


# zamba2-7b's fused in_proj (z, x, B, C, dt) and convolution channels (x, B, C)
IN_PROJ = _segments((7168, True), (7168, True), (64, False), (64, False), (112, True))
CONV = _segments((7168, True), (64, False), (64, False))

# (arch, tp, leaf path without list positions, want (spec over model, gradient kind))
LAYOUT_CASES = [
    # 112 Mamba2 heads over 16: z, x and dt by heads, B and C whole (partial
    # sums); the norm spans the joined heads; out_proj by d_model columns
    ("zamba2-7b", 16, ("prologue", "mamba", "in_proj", "w"), ((None, IN_PROJ), "sum")),
    ("zamba2-7b", 16, ("groups", "mamba", "conv_w"), ((None, CONV), "sum")),
    ("zamba2-7b", 16, ("groups", "mamba", "conv_b"), ((CONV,), "sum")),
    ("zamba2-7b", 16, ("groups", "mamba", "A_log"), (("model",), "shard")),
    ("zamba2-7b", 16, ("groups", "mamba", "D"), (("model",), "shard")),
    ("zamba2-7b", 16, ("groups", "mamba", "norm", "scale"), ((None,), "same")),
    ("zamba2-7b", 16, ("groups", "mamba", "out_proj", "w"), ((None, "model"), "shard")),
    ("zamba2-7b", 16, ("shared_attn", "attn", "wq", "w"), ((None, "model"), "shard")),
    ("zamba2-7b", 16, ("emb", "table"), (("model", None), "shard")),
    # 64 RWKV6 heads over 16: the heads' products, decay, u and the per-head
    # ln_x split; the token-shift mixes and the LoRAs' first products whole;
    # the channel mix's wr on wv's output columns
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "wr", "w"), ((None, "model"), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "wo", "w"), ((None, "model"), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "decay_w2"), ((None, "model"), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "decay"), (("model",), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "u"), (("model", None), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "ln_x", "scale"), (("model",), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "maa_w1"), ((None, None), "same")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "maa_w2"), ((None, None, None), "same")),
    ("rwkv6-7b", 16, ("blocks", "block", "tmix", "decay_w1"), ((None, None), "same")),
    ("rwkv6-7b", 16, ("blocks", "block", "cmix", "wk", "w"), ((None, "model"), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "cmix", "wv", "w"), ((None, "model"), "shard")),
    ("rwkv6-7b", 16, ("blocks", "block", "cmix", "wr", "w"), ((None, "model"), "shard")),
    ("rwkv6-7b", 16, ("unembed", "w"), ((None, "model"), "shard")),
    # 20 heads over 16: whisper's attentions whole; d_ff and d_model split;
    # the vocabulary 51866 and pos_dec whole
    ("whisper-large-v3", 16, ("enc_blocks", "attn", "wq", "w"), ((None, None), "same")),
    ("whisper-large-v3", 16, ("dec_blocks", "xattn", "wk", "w"), ((None, None), "same")),
    ("whisper-large-v3", 16, ("dec_blocks", "mlp", "wu", "w"), ((None, "model"), "shard")),
    ("whisper-large-v3", 16, ("dec_blocks", "mlp", "wd", "w"), ((None, "model"), "shard")),
    ("whisper-large-v3", 16, ("emb", "table"), ((None, None), "same")),
    ("whisper-large-v3", 16, ("pos_dec",), ((None, None), "same")),
]

# tp values that divide some of a model's dims and not others
ODD_TP_CASES = [
    # 112 Mamba2 heads over 7 split; 32 attention heads do not (whole), d_ff
    # and d_model do, the vocabulary 32000 does not
    ("zamba2-7b", 7, ("groups", "mamba", "in_proj", "w"),
     ((None, _segments((7168, True), (7168, True), (64, False), (64, False), (112, True))),
      "sum")),
    ("zamba2-7b", 7, ("shared_attn", "attn", "wk", "w"), ((None, None), "same")),
    ("zamba2-7b", 7, ("shared_attn", "mlp", "wg", "w"), ((None, "model"), "shard")),
    ("zamba2-7b", 7, ("emb", "table"), ((None, None), "same")),
    # 32 attention heads over 32 split; 112 Mamba2 heads do not: the layer whole
    ("zamba2-7b", 32, ("prologue", "mamba", "in_proj", "w"), ((None, None), "same")),
    ("zamba2-7b", 32, ("prologue", "mamba", "A_log"), ((None,), "same")),
    ("zamba2-7b", 32, ("shared_attn", "attn", "wq", "w"), ((None, "model"), "shard")),
    # 64 heads over 7 do not split (the time mix whole), d_ff 14336 does and
    # d_model 4096 does not: wv and wr whole on every rank
    ("rwkv6-7b", 7, ("blocks", "block", "tmix", "wr", "w"), ((None, None), "same")),
    ("rwkv6-7b", 7, ("blocks", "block", "tmix", "ln_x", "scale"), ((None,), "same")),
    ("rwkv6-7b", 7, ("blocks", "block", "cmix", "wk", "w"), ((None, "model"), "shard")),
    ("rwkv6-7b", 7, ("blocks", "block", "cmix", "wv", "w"), ((None, None), "same")),
    ("rwkv6-7b", 7, ("blocks", "block", "cmix", "wr", "w"), ((None, None), "same")),
    # 20 heads over 4 split (MHA: the cross-attention's wk by kv heads), the
    # vocabulary 51866 does not; over 2 it does
    ("whisper-large-v3", 4, ("dec_blocks", "xattn", "wk", "w"), ((None, "model"), "shard")),
    ("whisper-large-v3", 4, ("dec_blocks", "xattn", "wo", "w"), ((None, "model"), "shard")),
    ("whisper-large-v3", 4, ("enc_blocks", "attn", "wv", "b"), (("model",), "shard")),
    ("whisper-large-v3", 4, ("emb", "table"), ((None, None), "same")),
    ("whisper-large-v3", 2, ("emb", "table"), (("model", None), "shard")),
]


def _layout(arch, tp):
    cfg = tregistry.get(arch)
    params = tapi.init(cfg, device="meta")
    return dict(zip([_port_key(p) for p, _ in tree.leaves_with_paths(params)],
                    tshd.compute_layout(cfg, params, FakeMesh(data=16, model=tp))))


@pytest.mark.parametrize("arch,tp,leaf,want", LAYOUT_CASES + ODD_TP_CASES,
                         ids=[f"{a}-tp{t}-{'/'.join(l)}"
                              for a, t, l, _ in LAYOUT_CASES + ODD_TP_CASES])
def test_compute_layout_of_the_ssm_and_encdec_families(arch, tp, leaf, want):
    layout = _layout(arch, tp)
    assert layout[leaf] == want
    assert all(g in ("shard", "sum", "same") for _, g in layout.values())


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_every_family_takes_the_partitioned_route(arch):
    cfg = tregistry.get(arch)
    assert cfg.family == FAMILIES[arch] and ttrainer.route(cfg) == "partitioned"
    assert set(ttrainer.PARTITIONED_FAMILIES) == {tregistry.get(a).family
                                                  for a in tregistry.ARCHS}


def test_segments_take_each_ranks_heads_and_the_shared_columns_whole():
    """Rank r's columns of a fused projection: its block of each split
    segment and the whole of the others, in order; every column of a split
    segment on exactly one rank."""
    seg = tshd.Segments((8, 8, 2, 2, 4), (True, True, False, False, True))
    cols = torch.arange(24.0)[None]
    got = [seg.take(cols, 1, 2, r)[0].long().tolist() for r in range(2)]
    assert got[0] == [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19, 20, 21]
    assert got[1] == [4, 5, 6, 7, 12, 13, 14, 15, 16, 17, 18, 19, 22, 23]
    assert seg.take(cols, 1, 1, 0) is cols


# reduced configs (d 64): zamba2 2 Mamba2 heads and 4 attention heads, rwkv6 4
# heads of 16, whisper 4 heads and 8 frames. On 2 x 2 tp 2 divides every dim
# the layout splits. On (1, 4) zamba2's 2 Mamba2 heads stay whole and its 4
# attention heads split; on (1, 3) rwkv6 with d_ff 96: the time mix whole, wk
# by d_ff, wv and wr on all their columns (d_model 64); whisper with 12 heads
# (MHA) and d_ff 96: heads and d_ff split, d_model and the vocabulary 256 whole
JOBS = {"zamba2-7b": dict(arch="zamba2-7b", mesh=[2, 2], batch=4, seq=32, steps=3,
                          microbatches=1),
        "rwkv6-7b": dict(arch="rwkv6-7b", mesh=[2, 2], batch=4, seq=80, steps=3,
                         microbatches=1),
        "whisper-large-v3": dict(arch="whisper-large-v3", mesh=[2, 2], batch=4, seq=16,
                                 steps=3, microbatches=1),
        "zamba2-7b-tp4": dict(arch="zamba2-7b", mesh=[1, 4], batch=2, seq=32, steps=3,
                              microbatches=1),
        "rwkv6-7b-tp3": dict(arch="rwkv6-7b", mesh=[1, 3], batch=2, seq=32, steps=3,
                             microbatches=1, replace={"d_ff": 96}),
        "whisper-large-v3-tp3": dict(arch="whisper-large-v3", mesh=[1, 3], batch=2, seq=16,
                                     steps=3, microbatches=1,
                                     replace={"num_heads": 12, "num_kv_heads": 12,
                                              "d_ff": 96})}


@pytest.fixture(scope="module", params=list(JOBS))
def family_run(request, tmp_path_factory):
    job = JOBS[request.param]
    out = _run_ranks(tmp_path_factory.mktemp(request.param), job, n=int(np.prod(job["mesh"])))
    want = _single_device(job["arch"], job["batch"], job["seq"], job["steps"],
                          job["microbatches"], job.get("replace"))
    return request.param, out, want


def test_sharded_families_match_the_single_device_run(family_run):
    """Losses, global gradient norms and the gathered parameters of 3
    partitioned steps within ``TOL`` of one device; the worker asserted the
    partitioned route, no parameter gathered whole with ``full_tensor`` and
    model-group all-reduces (the split inputs' gradients)."""
    name, out, (metrics, params) = family_run
    assert out["model_reduces"] > 0
    for got, want in zip(out["metrics"], metrics):
        for k in ("loss", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=TOL, abs=TOL), (name, k, got, want)
    assert len(out["params"]) == len(params)
    for got, want in zip(out["params"], params):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_the_reduced_jobs_split_what_their_names_say():
    """The layouts the jobs above run in."""
    def lay(name):
        job = JOBS[name]
        cfg = dataclasses.replace(tregistry.get(job["arch"]).reduced(),
                                  **job.get("replace", {}))
        return tshd.model_layout(cfg, job["mesh"][1])

    for name in ("zamba2-7b", "rwkv6-7b", "whisper-large-v3"):
        got = lay(name)
        assert got.d_ff and got.d_model and got.vocab and got.heads
    assert lay("zamba2-7b").ssm_heads and lay("rwkv6-7b").ssm_heads
    tp4 = lay("zamba2-7b-tp4")
    assert not tp4.ssm_heads and tp4.heads and tp4.kv_heads and tp4.d_ff
    tp3 = lay("rwkv6-7b-tp3")
    assert not tp3.ssm_heads and tp3.d_ff and not tp3.d_model and not tp3.vocab
    tp3 = lay("whisper-large-v3-tp3")
    assert tp3.heads and tp3.kv_heads and tp3.d_ff and not tp3.d_model and not tp3.vocab
