"""RWKV6 "Finch" block: data-dependent decay linear RNN (attention-free).

Time-mix uses per-channel decay w_t[i] in (0,1); the chunked-parallel form
keeps every exponent non-positive:

  y_t = r~_t @ S_0 + sum_{s<t} (sum_i r_t[i] k_s[i] e^{lc[t-1,i]-lc[s,i]}) v_s
        + (r_t . (u*k_t)) v_t
  S'  = diag(e^{lc[Q]}) S_0 + sum_s diag(e^{lc[Q]-lc[s]}) k_s v_s^T

where lc is the within-chunk cumulative log decay (lc <= 0, lc[t-1]-lc[s] <= 0
for s <= t-1). The (Q,Q,p) contraction is exact: no log-space clamping. The
state is carried from chunk to chunk by a Python loop.

Types: ``time_mix`` and ``channel_mix`` compute in fp32 with every weight
widened at use, whatever the compute type (the block's input and output keep
theirs); the state and the token-shift carries are fp32. On a CUDA tensor those
fp32 products are full fp32 as long as the caller leaves
``torch.backends.cuda.matmul.allow_tf32`` at its default (False): this module
sets no global precision.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import ctx as pctx

N_MIX = 5          # w, k, v, r, g DDLerp mixes
LORA_MIX = 32
LORA_DECAY = 64


def rwkv_init(gen, cfg):
    d = cfg.d_model
    p = cfg.rwkv_head_dim
    H = d // p
    f32 = dict(dtype=torch.float32, device=gen.device)
    tn = layers.truncated_normal

    def z(*shape):
        return torch.zeros(shape, **f32)

    return {
        "tmix": {
            "maa_x": z(d), "maa_wkvrg": z(N_MIX, d),
            "maa_w1": tn(gen, (d, N_MIX * LORA_MIX), 0.02),
            "maa_w2": tn(gen, (N_MIX, LORA_MIX, d), 0.02),
            "decay": torch.full((d,), -4.0, **f32),
            "decay_w1": tn(gen, (d, LORA_DECAY), 0.02),
            "decay_w2": tn(gen, (LORA_DECAY, d), 0.02),
            "u": tn(gen, (H, p), 0.3),
            "wr": layers.dense_init(gen, d, d),
            "wk": layers.dense_init(gen, d, d),
            "wv": layers.dense_init(gen, d, d),
            "wg": layers.dense_init(gen, d, d),
            "wo": layers.dense_init(gen, d, d),
            "ln_x": {"scale": torch.ones((d,), **f32), "bias": z(d)},
        },
        "cmix": {
            "maa_k": z(d), "maa_r": z(d),
            "wk": layers.dense_init(gen, d, cfg.d_ff),
            "wv": layers.dense_init(gen, cfg.d_ff, d),
            "wr": layers.dense_init(gen, d, d),
        },
    }


def _token_shift(x, x_prev):
    """x: (B,S,d); x_prev: (B,d) last token of the previous call."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _group_norm(p, x, H):
    """Per-head LayerNorm with the population variance, eps 1e-5."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = torch.square(xh - mu).mean(dim=-1, keepdim=True)
    y = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (y.reshape(B, S, d) * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _wkv_chunked(r, k, v, lw, u, S0, Q):
    """The chunked scan. r, k, v, lw (B,S,H,p), u (H,p), S0 (B,H,p,p), all fp32.
    Returns (y (B,S,H*p), final state)."""
    B, S, H, ph = r.shape
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        # zero log-decay on the padded rows: w = 1, and their zero k adds nothing
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))

    def chunks(t):                                            # (nc, B, H, Q, p)
        return t.reshape(B, nc, Q, H, ph).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(chunks, (r, k, v, lw))
    tri = torch.ones((Q, Q), dtype=torch.bool, device=r.device).tril(-1)   # strict lower
    state, ys = S0, []
    for c in range(nc):
        rq, kq, vq, la = rc[c], kc[c], vc[c], lwc[c]          # (B,H,Q,p)
        lc = torch.cumsum(la, dim=2)
        lprev = torch.cat([torch.zeros_like(lc[:, :, :1]), lc[:, :, :-1]], dim=2)   # lc[t-1]
        # A[t,s] = sum_i r[t,i] k[s,i] exp(lprev[t,i] - lc[s,i]), s < t. On and above
        # the diagonal rel >= 0 and exp(rel) may overflow: the where drops it
        # before any product, as in the reference
        rel = lprev[:, :, :, None, :] - lc[:, :, None, :, :]  # (B,H,Q,Q,p)
        E = torch.where(tri[None, None, :, :, None], torch.exp(rel), 0.0)
        A = torch.einsum("bhtsi,bhsi->bhts", rq[:, :, :, None, :] * E, kq)
        diag = torch.einsum("bhti,hi,bhti->bht", rq, u, kq)
        y = torch.einsum("bhts,bhsj->bhtj", A, vq) + diag[..., None] * vq
        y = y + torch.einsum("bhti,bhij->bhtj", rq * torch.exp(lprev), state)
        # S' = diag(e^{lc[Q]}) S0 + sum_s diag(e^{lc[Q]-lc[s]}) k_s v_s^T
        k_hat = kq * torch.exp(lc[:, :, -1:, :] - lc)
        state = state * torch.exp(lc[:, :, -1])[..., None] + torch.einsum(
            "bhsi,bhsj->bhij", k_hat, vq)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nc * Q, H * ph)
    return y[:, :S], state


def time_mix(p, x, cfg, *, S0, x_prev, chunk: int = 64):
    """x: (B,S,d). S0: (B,H,p,p) state (k-dim, v-dim). Returns y, S', x_last.

    Where the layout of ``parallel.ctx.model_parallel`` splits the heads,
    ``p`` holds this model rank's block of the head-shaped leaves
    (``parallel.sharding.compute_layout``): the token-shift mixes and the
    LoRAs' first products run alike on every rank; ``wr`` / ``wk`` / ``wv`` /
    ``wg`` and ``decay_w2`` are ``layers.split_mm`` products on the rank's
    heads, the scan, ``u`` and the per-head ``ln_x`` run on them, and ``wo``
    is ``layers.dense_joined`` over the ranks' heads. ``S0`` is then a state
    of every head (a prefill's zero state), of which the rank takes its
    heads, or one of the rank's heads alone (the state a sharded prefill or
    decode step returned, ``serve.decode``'s), taken as it is; the state
    returned holds the rank's heads.

    Under sequence parallelism (``parallel.ctx.seq_parallel()``) ``x`` is
    this model rank's rows and so is ``y``: the mix runs on the sequence
    gathered alike on every rank (``parallel.ctx.seq_gather``; the token
    shift needs the previous rank's last row), its split products' partial
    input gradients summed by ``layers.whole_input``, and the rank keeps its
    rows of the output. ``x_last`` is the whole sequence's."""
    x = pctx.seq_gather(x)
    B, S, d = x.shape
    ph = cfg.rwkv_head_dim
    H = d // ph
    lay = pctx.layout()
    split = lay is not None and lay.ssm_heads
    w = {k: p[k].float() for k in ("maa_x", "maa_wkvrg", "maa_w1", "maa_w2", "decay",
                                   "decay_w1", "decay_w2", "u")}
    xf = x.float()
    sx = _token_shift(xf, x_prev)
    dx = sx - xf
    xxx = xf + dx * w["maa_x"]
    mix = torch.tanh(xxx @ w["maa_w1"]).reshape(B, S, N_MIX, LORA_MIX)
    mix = torch.einsum("bsnl,nld->bsnd", mix, w["maa_w2"])               # (B,S,5,d)
    xw, xk, xv, xr, xg = [xf + dx * (w["maa_wkvrg"][i] + mix[:, :, i])
                          for i in range(N_MIX)]

    def proj(xm, wm):
        return layers.split_mm(layers.whole_input(xm), wm) if split else xm @ wm

    if split:
        H //= pctx.model_size()
        if S0.shape[1] != H:                  # a state of every head: the rank's heads of it
            S0 = S0[:, pctx.model_index() * H:(pctx.model_index() + 1) * H]
    logw = -torch.exp(w["decay"] + proj(torch.tanh(xw @ w["decay_w1"]), w["decay_w2"]))
    logw = torch.clamp(logw, -60.0, -1e-5)                                # (B,S,d) < 0
    r = proj(xr, p["wr"]["w"].float()).reshape(B, S, H, ph)
    k = proj(xk, p["wk"]["w"].float()).reshape(B, S, H, ph)
    v = proj(xv, p["wv"]["w"].float()).reshape(B, S, H, ph)
    g = F.silu(proj(xg, p["wg"]["w"].float()))
    lw = logw.reshape(B, S, H, ph)
    u = w["u"]
    S0 = S0.float()

    if S == 1:  # decode: y = r.(S0 + u k v^T); S' = diag(w) S0 + k v^T
        r1, k1, v1, lw1 = r[:, 0], k[:, 0], v[:, 0], lw[:, 0]
        kv = k1[..., :, None] * v1[..., None, :]                          # (B,H,p,p)
        y = torch.einsum("bhi,bhij->bhj", r1, S0 + u[None, :, :, None] * kv)
        S_new = S0 * torch.exp(lw1)[..., None] + kv
        y = y.reshape(B, 1, H * ph)
    else:
        y, S_new = _wkv_chunked(r, k, v, lw, u, S0, min(chunk, S))

    y = _group_norm(p["ln_x"], y, H)
    if split:
        y = layers.dense_joined(p["wo"], y.float() * g, dtype=torch.float32)
    else:
        y = pctx.seq_rows((y.float() * g) @ p["wo"]["w"].float())
    # a copy: a view would keep the whole (B, S, d) fp32 input alive in a cache
    return y.to(x.dtype), S_new, xf[:, -1].clone()


def channel_mix(p, x, *, x_prev):
    """Where the layout of ``parallel.ctx.model_parallel`` splits ``d_ff``,
    ``wk`` is a ``layers.split_mm`` product on this model rank's hidden units
    and ``wv`` the pair's second product (``layers.joined_mm``). Where it also
    splits ``d_model``, ``wr`` holds the rank's block of the output columns
    that ``wv`` gives it: the receptance gate multiplies that block, and the
    ranks' gated blocks are joined. Else ``wr`` and the gate run whole, alike
    on every rank. Under sequence parallelism ``x`` is this model rank's
    rows and so is ``y``, as in ``time_mix``: the gated blocks are turned
    into the rank's rows where they were joined (``parallel.ctx.join_columns``),
    and a rank computing the whole output keeps its rows."""
    x = pctx.seq_gather(x)
    xf = x.float()
    sx = _token_shift(xf, x_prev)
    dx = sx - xf
    xk = xf + dx * p["maa_k"].float()
    xr = xf + dx * p["maa_r"].float()
    lay = pctx.layout()
    if lay is None or not lay.d_ff:
        k = torch.square(F.relu(xk @ p["wk"]["w"].float()))
        kv = k @ p["wv"]["w"].float()
        y = torch.sigmoid(xr @ p["wr"]["w"].float()) * kv
        return pctx.seq_rows(y).to(x.dtype), xf[:, -1].clone()
    k = torch.square(F.relu(layers.split_mm(layers.whole_input(xk), p["wk"]["w"].float())))
    kv = layers.joined_mm(k, p["wv"]["w"].float(), split=lay.d_model, join=False)
    if lay.d_model:
        r = layers.split_mm(layers.whole_input(xr), p["wr"]["w"].float())
        y = pctx.join_columns(torch.sigmoid(r) * kv)
    else:
        y = pctx.seq_rows(torch.sigmoid(xr @ p["wr"]["w"].float()) * kv)
    return y.to(x.dtype), xf[:, -1].clone()


def rwkv_state_init(cfg, batch, *, device):
    """A zero state, fp32 whatever the compute type."""
    d = cfg.d_model
    p = cfg.rwkv_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"S": torch.zeros((batch, d // p, p, p), **f32),
            "x_att": torch.zeros((batch, d), **f32),
            "x_cmix": torch.zeros((batch, d), **f32)}


def rwkv_block(params, x, cfg, norms, *, state):
    """One RWKV layer: ln1 -> time_mix -> ln2 -> channel_mix (pre-norm).
    Returns (x, new state); the state given is not written."""
    h, S_new, x_att = time_mix(
        params["tmix"], layers.apply_norm("layernorm", norms["ln1"], x), cfg,
        S0=state["S"], x_prev=state["x_att"])
    x = x + h
    h, x_cm = channel_mix(
        params["cmix"], layers.apply_norm("layernorm", norms["ln2"], x),
        x_prev=state["x_cmix"])
    x = x + h
    return x, {"S": S_new, "x_att": x_att, "x_cmix": x_cm}
