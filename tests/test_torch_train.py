"""The port's training path against the JAX package's: the chunked loss, the
optimizer, the train step (loss, gradients, 8 steps), remat, microbatching,
int8 error feedback, and the gradient of the attention forward.

Inputs are made by numpy from a seed and handed to both sides
(``repro_torch.compat``). On the CPU the port's attention takes the plain
versions of its kernels; its gradient is autograd of the plain version
(``flash_attention.FlashAttentionFn``), the JAX side's is XLA's autodiff of
``flash_ref``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import token_batch
from repro.models import attention as jattn
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import compat, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.train import loss as tloss
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

from test_torch_models import numpy_params, reference_mlp_follows_compute_dtype  # noqa: F401

gpu = pytest.mark.gpu

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
# fp32 compute on both sides; what is left is the order of summation, the last
# bits of exp / rsqrt / sin / cos, and bf16 roundings of the loss's matmul that
# both sides make at the same places
F32_GRADS = dict(rtol=1e-4, atol=1e-5)
F32_ATTN = dict(rtol=2e-5, atol=2e-5)


def _both(arch="olmo-1b", dtype="bfloat16", seed=0):
    cj = dataclasses.replace(jregistry.get(arch).reduced(), compute_dtype=dtype)
    ct = dataclasses.replace(tregistry.get(arch).reduced(), compute_dtype=dtype)
    return cj, ct, numpy_params(cj, seed)


def _jax_state(tree_np):
    params = jax.tree.map(jnp.asarray, tree_np)
    return jtrainer.TrainState(params=params, opt_state=jopt.init(params), ef_error=None)


def _torch_state(ct, tree_np):
    params = compat.params_from_jax(ct, tree_np, device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return ttrainer.TrainState(params=params, opt_state=topt.init(params), ef_error=None)


def _batch(cfg, step, batch=4, seq=16):
    b = token_batch(cfg, batch=batch, seq=seq, step=step)
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}


def _rel(a, b):
    a, b = (float(x.detach()) if isinstance(x, torch.Tensor) else float(x) for x in (a, b))
    return abs(a - b) / abs(b)


@pytest.fixture(scope="module")
def jax_steps():
    """Jitted JAX train steps shared by the tests of this file, by key."""
    return {}


def _jax_step(cache, key, cj, run):
    if key not in cache:
        cache[key] = jax.jit(jtrainer.make_train_step(cj, run))
    return cache[key]


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------

def test_chunked_cross_entropy_matches_jax():
    """Padding (30 tokens in chunks of 8) and ignored labels; loss, weight and
    both gradients."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 10, 32), dtype=np.float32)
    w = (rng.standard_normal((32, 96)) / 6).astype(np.float32)
    y = rng.integers(0, 96, (3, 10)).astype(np.int32)
    y[0, :3] = -1
    y[2, -1] = -1

    def jfn(h, w):
        return jloss.chunked_cross_entropy(h, w, jnp.asarray(y), chunk=8)

    lj, wj = jfn(jnp.asarray(h), jnp.asarray(w))
    gj = jax.grad(lambda a, b: jfn(a, b)[0], argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    lt, wt_sum = tloss.chunked_cross_entropy(ht, wt, torch.from_numpy(y), chunk=8)
    gt = torch.autograd.grad(lt, (ht, wt))
    assert float(wt_sum) == float(wj) == 26.0
    assert _rel(lt, lj) < 1e-4
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_GRADS)
    with torch.no_grad():                    # no checkpoint without grad: same value
        assert float(tloss.chunked_cross_entropy(ht, wt, torch.from_numpy(y), chunk=8)[0]) \
            == float(lt)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedule_lr_matches_jax(schedule):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    want = np.array([float(jopt.schedule_lr(jc, s)) for s in range(101)])
    got = np.array([float(topt.schedule_lr(tc, s)) for s in range(101)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # a tensor step gives the same number as an int
    assert float(topt.schedule_lr(tc, torch.tensor(37, dtype=torch.int32))) == got[37]


def test_apply_updates_matches_jax_over_three_steps():
    """Clipping on, weight decay on: the decay mask spares ``b``, ``scale``,
    ``bias`` and 1-d leaves, and walks lists."""
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 3), "b": (3,), "vec": (5,), "norm": {"scale": (3,), "bias": (3,)},
              "blocks": [{"w": (3, 3), "b": (3,)}, {"w": (3, 2), "scale": (2,)}]}
    p_np = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=0.5)
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    pj = jax.tree.map(jnp.asarray, p_np)
    sj = jopt.init(pj)
    pt = tree.map_leaves(torch.from_numpy, jax.tree.map(np.copy, p_np))
    st = topt.init(pt)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), p_np)
        pj, sj, mj = jopt.apply_updates(jc, pj, jax.tree.map(jnp.asarray, g_np), sj)
        pt, st, mt = topt.apply_updates(tc, pt, tree.map_leaves(torch.from_numpy, g_np), st)
        assert _rel(mt["grad_norm"], mj["grad_norm"]) < 1e-6
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=1e-6)
    assert int(st.step) == int(sj.step) == 3
    for got, want in ((pt, pj), (st.m, sj.m), (st.v, sj.v)):
        for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_optimizer_refuses_an_unknown_schedule():
    with pytest.raises(ValueError, match="linear"):
        topt.schedule_lr(topt.OptConfig(schedule="linear"), 3)


def test_wsd_schedule_shape():
    cfg = topt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100, schedule="wsd",
                         wsd_stable_frac=0.8, min_lr_frac=0.1)
    lrs = [float(topt.schedule_lr(cfg, s)) for s in range(101)]
    assert lrs[5] == pytest.approx(0.5)               # warmup
    assert lrs[50] == pytest.approx(1.0)              # stable plateau
    assert lrs[100] == pytest.approx(0.1, abs=0.02)   # decayed to min
    assert all(a >= b - 1e-6 for a, b in zip(lrs[10:], lrs[11:]))  # monotone


# ---------------------------------------------------------------------------
# the train step against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "llama3-8b"])   # tied and untied unembedding
def test_step1_grads_match_jax_fp32(arch, reference_mlp_follows_compute_dtype):
    cj, ct, tree_np = _both(arch, "float32")
    bj, bt = _batch(cj, 0)
    run_kw = dict(remat="none")
    (lj, _), gj = jax.value_and_grad(jtrainer.make_loss_fn(cj, jtrainer.RunConfig(**run_kw)),
                                     has_aux=True)(jax.tree.map(jnp.asarray, tree_np), bj)
    params = _torch_state(ct, tree_np).params
    lt, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(**run_kw))(params, bt)
    gt = torch.autograd.grad(lt, tree.leaves(params))
    assert _rel(lt, lj) < 1e-5
    back = compat.params_to_jax(ct, tree.rebuild(params, list(gt)))
    assert jax.tree.structure(back) == jax.tree.structure(gj)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(gj), jax.tree.leaves(back)):
        np.testing.assert_allclose(got, np.asarray(want), **F32_GRADS,
                                   err_msg=jax.tree_util.keystr(path))


def test_eight_steps_match_jax_fp32(jax_steps, reference_mlp_follows_compute_dtype):
    """make_train_step with the default remat ("full") on both sides."""
    cj, ct, tree_np = _both("olmo-1b", "float32")
    step_j = _jax_step(jax_steps, "f32", cj, jtrainer.RunConfig(opt=jopt.OptConfig(**OPT)))
    step_t = ttrainer.make_train_step(ct, ttrainer.RunConfig(opt=topt.OptConfig(**OPT)))
    sj, st = _jax_state(tree_np), _torch_state(ct, tree_np)
    for i in range(8):
        bj, bt = _batch(cj, i)
        sj, mj = step_j(sj, bj)
        st, mt = step_t(st, bt)
        assert _rel(mt["loss"], mj["loss"]) < 1e-3, i
        assert _rel(mt["grad_norm"], mj["grad_norm"]) < 1e-3, i
        assert abs(float(mt["lr"]) - float(mj["lr"])) < 1e-7, i
    assert int(st.opt_state.step) == 8


def test_bf16_step1_loss_matches_jax(jax_steps):
    cj, ct, tree_np = _both("olmo-1b", "bfloat16")
    step_j = _jax_step(jax_steps, "bf16", cj, jtrainer.RunConfig(opt=jopt.OptConfig(**OPT)))
    step_t = ttrainer.make_train_step(ct, ttrainer.RunConfig(opt=topt.OptConfig(**OPT)))
    bj, bt = _batch(cj, 0)
    _, mj = step_j(_jax_state(tree_np), bj)
    _, mt = step_t(_torch_state(ct, tree_np), bt)
    assert np.isfinite(float(mt["loss"]))
    assert _rel(mt["loss"], mj["loss"]) < 2e-2


def test_attention_weights_get_gradients():
    """The severed-gradient fault: through ops.mha_forward, wq/wk/wv get a gradient."""
    _, ct, tree_np = _both("olmo-1b", "bfloat16")
    params = _torch_state(ct, tree_np).params
    _, bt = _batch(ct, 0)
    loss, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(remat="none"))(params, bt)
    attn = params["blocks"][0]["attn"]
    grads = torch.autograd.grad(loss, [attn[n]["w"] for n in ("wq", "wk", "wv")])
    assert all(float(g.abs().sum()) > 0 for g in grads)


def test_non_dense_families_are_refused():
    """Every family of the registry is ported now (ssm and encdec too): only a
    family the port has no model of is refused, by name."""
    for arch in ("rwkv6-7b", "whisper-large-v3"):
        cfg = tregistry.get(arch).reduced()
        ttrainer.make_loss_fn(cfg, ttrainer.RunConfig())
    cfg = dataclasses.replace(tregistry.get("rwkv6-7b").reduced(), family="retnet")
    with pytest.raises(NotImplementedError, match="'retnet'.*not ported"):
        ttrainer.make_loss_fn(cfg, ttrainer.RunConfig())
    with pytest.raises(NotImplementedError, match="'retnet'.*not ported"):
        ttrainer.init_state(cfg, ttrainer.RunConfig(), 0, device="cpu")


# ---------------------------------------------------------------------------
# the attention forward under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [16, 64])
def test_flash_attention_fn_backward_matches_jax_flash_ref(causal, G, D):
    B, Hkv, L = 2, 2, 24
    S = L if causal else 40
    rng = np.random.default_rng(G * 100 + D + causal)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, L, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    r = rng.standard_normal((B, L, Hkv * G, D), dtype=np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(jattn.flash_ref(a, b, c, causal=causal) * r),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tops.mha_forward(*ins, causal=causal)
    got = torch.autograd.grad((o * torch.from_numpy(r)).sum(), ins)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_ATTN)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_attention_fn_backward_bf16_on_the_cpu_matches_jax_flash_ref(causal, G):
    """bf16 on the CPU: the forward is the plain version with P kept fp32, so the
    backward must differentiate that function (P is rounded to bf16 only on the
    card, where the kernel rounds it), as ``jax.grad`` of ``flash_ref`` does.
    Both sides round the inputs, the output, the incoming gradient and the
    returned gradients to bf16 at the same places and differ only where fp32
    summation order flips a rounding: within 5e-4 in norm (rounding P in the
    backward as well gives about 3e-3), and within the bf16 tolerance 2e-2
    elementwise."""
    B, Hkv, L, D = 2, 2, 24, 64
    S = L if causal else 40
    rng = np.random.default_rng(G * 10 + causal)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((B, L, Hkv * G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    r = rng.standard_normal((B, L, Hkv * G, D), dtype=np.float32)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jattn.flash_ref(a, b, c, causal=causal).astype(jnp.float32) * r),
        argnums=(0, 1, 2))(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    ins = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v)]
    o = tops.mha_forward(*ins, causal=causal)
    got = torch.autograd.grad((o.float() * torch.from_numpy(r)).sum(), ins)
    for a, b in zip(got, want):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 5e-4
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("chunk,pv_bf16,device,dtype,mode,route", [
    (512, False, "cuda", torch.float32, None, "kernel"),
    (512, True, "cuda", torch.bfloat16, None, "kernel"),     # the bf16 kernel rounds P
    (512, True, "cuda", torch.float32, None, "refused"),     # the fp32 kernel keeps P fp32
    (128, False, "cuda", torch.bfloat16, None, "refused"),
    (128, True, "cuda", torch.bfloat16, "reference", "flash_ref"),
    (8, True, "cpu", torch.bfloat16, None, "flash_ref"),
    (8, False, "cpu", torch.float32, None, "flash_ref"),
])
def test_attention_knobs_take_the_kernel_or_are_refused_on_the_card(
        chunk, pv_bf16, device, dtype, mode, route):
    """``attn_chunk`` / ``attn_pv_bf16`` map to ``flash_ref`` on the CPU and under
    mode="reference", as in the reference; on the card they never leave the
    kernel for the plain version."""
    if route == "refused":
        with pytest.raises(NotImplementedError, match="no kernel on the card"):
            tattn.knob_attention(chunk, pv_bf16, device=device, dtype=dtype, mode=mode)
        return
    fn = tattn.knob_attention(chunk, pv_bf16, device=device, dtype=dtype, mode=mode)
    if route == "kernel":
        assert fn is None
    else:
        assert fn.func is tattn.flash_ref
        assert fn.keywords == {"chunk": chunk, "pv_bf16": pv_bf16}


def _through_the_function(o):
    """Whether ``o``'s graph reaches FlashAttentionFn's backward."""
    seen, todo = set(), [o.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if "FlashAttentionFn" in type(fn).__name__:
            return True
        todo += [f for f, _ in fn.next_functions]
    return False


def test_mha_forward_routes_through_the_function_only_under_grad():
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    with torch.no_grad():
        assert tops.mha_forward(q, k, v).grad_fn is None
    assert tops.mha_forward(q, k, v).grad_fn is None        # nothing requires grad
    q.requires_grad_(True)
    assert _through_the_function(tops.mha_forward(q, k, v))
    assert not _through_the_function(tops.mha_forward(q, k, v, mode="reference"))
    # only the inputs that need a gradient get one
    dq, = torch.autograd.grad(tops.mha_forward(q, k, v).sum(), [q])
    assert dq.shape == q.shape


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2), ("dots", 2),
                                             ("dots_no_batch", 2)])
def test_remat_reruns_the_forward_kernel(monkeypatch, remat, per_layer):
    """Under checkpointing the block's forward, and so the attention wrapper, runs
    again in the backward pass (the launch counters count it on the card)."""
    calls = []
    inner = tfa.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention", counting)
    _, ct, tree_np = _both("olmo-1b", "bfloat16")
    params = _torch_state(ct, tree_np).params
    _, bt = _batch(ct, 0, batch=2)
    loss, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(remat=remat))(params, bt)
    assert len(calls) == ct.num_layers
    torch.autograd.grad(loss, tree.leaves(params))
    assert len(calls) == per_layer * ct.num_layers


def test_unknown_remat_policy_raises():
    _, ct, tree_np = _both("olmo-1b", "bfloat16")
    params = _torch_state(ct, tree_np).params
    _, bt = _batch(ct, 0, batch=2)
    with pytest.raises(ValueError, match="unknown remat policy 'offload'"):
        ttrainer.make_loss_fn(ct, ttrainer.RunConfig(remat="offload"))(params, bt)


# ---------------------------------------------------------------------------
# torch ports of tests/test_ckpt_trainer.py's trainer semantics
# ---------------------------------------------------------------------------

def test_microbatch_equivalence():
    """4 microbatches produce the same loss and accumulated-gradient norm as 1."""
    _, ct, tree_np = _both("olmo-1b", "bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in token_batch(ct, batch=8, seq=16, step=0).items()}
    outs = {}
    for mb in (1, 4):
        run = ttrainer.RunConfig(microbatches=mb, remat="none", opt=topt.OptConfig(**OPT))
        _, m = ttrainer.make_train_step(ct, run)(_torch_state(ct, tree_np), batch)
        outs[mb] = (float(m["loss"]), float(m["grad_norm"]))
    assert outs[1][0] == pytest.approx(outs[4][0], rel=1e-5)
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-3)


def test_int8_grad_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))
    err = torch.zeros_like(g)
    deq, err2 = ttrainer._quantize_int8(g, err)
    np.testing.assert_allclose((deq + err2).numpy(), g.numpy(), rtol=1e-6, atol=1e-6)
    # the same quantisation as the reference's
    jdeq, jerr = jtrainer._quantize_int8(jnp.asarray(g.numpy()), jnp.zeros((64, 64)))
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), rtol=1e-6, atol=1e-7)
    # EF convergence: sum of dequantized updates -> n * g
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    n = 16
    for _ in range(n):
        deq, err = ttrainer._quantize_int8(g, err)
        acc = acc + deq
    np.testing.assert_allclose((acc / n).numpy(), g.numpy(), rtol=0,
                               atol=float(g.abs().max()) / 127)

    # and the trainer wires it: state carries a nonzero residual
    _, ct, _ = _both("olmo-1b", "bfloat16")
    run = ttrainer.RunConfig(microbatches=1, remat="none", grad_compress="int8",
                             opt=topt.OptConfig(**OPT))
    state = ttrainer.init_state(ct, run, 0, device="cpu")
    assert all(float(e.abs().sum()) == 0 for e in tree.leaves(state.ef_error))
    _, bt = _batch(ct, 0)
    state, _ = ttrainer.make_train_step(ct, run)(state, bt)
    assert sum(float(e.abs().sum()) for e in tree.leaves(state.ef_error)) > 0


def test_remat_matches_no_remat():
    _, ct, tree_np = _both("olmo-1b", "bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in token_batch(ct, batch=2, seq=16, step=0).items()}
    grads = {}
    for remat in ("none", "full", "dots", "dots_no_batch"):
        params = _torch_state(ct, tree_np).params
        loss, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(remat=remat))(params, batch)
        grads[remat] = torch.autograd.grad(loss, tree.leaves(params))
    for remat in ("full", "dots", "dots_no_batch"):
        for a, b in zip(grads["none"], grads[remat]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_cast_params_and_attention_knobs_follow_the_reference(jax_steps):
    """``cast_params="bfloat16"`` (every floating leaf cast, differentiably) and
    ``attn_chunk`` / ``attn_pv_bf16`` (the model's attention becomes
    ``flash_ref`` with those arguments), step 1 against the JAX step."""
    cj, ct, tree_np = _both("olmo-1b", "bfloat16")
    kw = dict(cast_params="bfloat16", attn_chunk=8, attn_pv_bf16=True)
    step_j = _jax_step(jax_steps, "knobs", cj,
                       jtrainer.RunConfig(opt=jopt.OptConfig(**OPT), **kw))
    step_t = ttrainer.make_train_step(ct, ttrainer.RunConfig(opt=topt.OptConfig(**OPT), **kw))
    bj, bt = _batch(cj, 0)
    _, mj = step_j(_jax_state(tree_np), bj)
    st, mt = step_t(_torch_state(ct, tree_np), bt)
    assert _rel(mt["loss"], mj["loss"]) < 2e-2
    assert _rel(mt["grad_norm"], mj["grad_norm"]) < 2e-2
    assert all(p.dtype == torch.float32 for p in tree.leaves(st.params))   # masters stay fp32


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@gpu
def test_flash_attention_fn_grads_through_the_kernels_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; python3 chip_smoke.py runs the same check")
    rng = np.random.default_rng(5)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for B, H, Hkv, L, D in [(2, 16, 16, 256, 128), (1, 8, 2, 300, 64)]:
            ins = [torch.from_numpy(rng.standard_normal((B, L, h, D), dtype=np.float32))
                   .cuda().to(dtype).requires_grad_(True) for h in (H, Hkv, Hkv)]
            r = torch.from_numpy(rng.standard_normal((B, L, H, D), dtype=np.float32)).cuda()
            n0 = tfa.launches
            out = {}
            for mode in (None, "reference"):
                o = tops.mha_forward(*ins, causal=True, mode=mode)
                out[mode] = (o.detach(),) + torch.autograd.grad((o.float() * r).sum(), ins)
            assert tfa.launches == n0 + 1
            for got, want in zip(out[None], out["reference"]):
                torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # the severed-gradient fault on the card: a reduced model's attention weights
    # get a gradient through the kernel, close to the plain route's
    _, ct, tree_np = _both("olmo-1b", "bfloat16")
    params = compat.params_from_jax(ct, tree_np, device="cuda")
    ws = [params["blocks"][0]["attn"][n]["w"].requires_grad_(True) for n in ("wq", "wk", "wv")]
    batch = {k: v.cuda() for k, v in _batch(ct, 0)[1].items()}
    grads = {}
    for mode in (None, "reference"):
        loss, _ = ttrainer.make_loss_fn(ct, ttrainer.RunConfig(), mode=mode)(params, batch)
        grads[mode] = torch.autograd.grad(loss, ws)
    for g, want in zip(grads[None], grads["reference"]):
        assert float(g.norm()) > 0
        assert float((g - want).norm() / want.norm()) < 2e-2
    # a knob the kernels do not take is refused on the card, not run plain
    with pytest.raises(NotImplementedError, match="no kernel on the card"):
        ttrainer.make_loss_fn(ct, ttrainer.RunConfig(attn_chunk=8))(params, batch)
