"""Mamba2 (SSD) block: chunked state-space dual form.

Per-head scalar decay a_t = exp(dt_t * A_head) makes the intra-chunk term a
plain masked (Q x Q) matrix. The inter-chunk state is carried by a Python loop
over chunks; all decay exponents are non-positive (stable).

Decode keeps (conv_state, ssm_state) and performs the O(1) recurrence.

Types: ``in_proj``, the inner norm and ``out_proj`` run in the compute type;
the convolution, ``dt``, ``A`` and every SSD product run in fp32. On a CUDA
tensor those fp32 products are full fp32 as long as the caller leaves
``torch.backends.cuda.matmul.allow_tf32`` at its default (False): this module
sets no global precision.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.parallel import ctx as pctx


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    p = 64                               # mamba2 head dim
    n_heads = d_inner // p
    return d_inner, p, n_heads


def mamba_init(gen, cfg):
    d = cfg.d_model
    N = cfg.ssm_state
    d_inner, p, n_heads = _dims(cfg)
    dev = gen.device
    d_proj = 2 * d_inner + 2 * N + n_heads     # z, x, B, C, dt
    in_proj = layers.dense_init(gen, d, d_proj)
    conv_w = layers.truncated_normal(gen, (cfg.ssm_conv, d_inner + 2 * N), 0.5)
    out_proj = layers.dense_init(gen, d_inner, d)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_inner + 2 * N,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((n_heads,), 0.01, **f32))),
        "norm": layers.norm_init("rmsnorm", d_inner, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). Returns (y, new_state)."""
    K = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([conv_state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    # a copy: a view would keep the whole (B, S + K - 1, C) input alive in the cache
    new_state = xp[:, -(K - 1):].clone() if K > 1 else conv_state
    return F.silu(y + b), new_state


def _ssd_chunked(xh, Bc, Cc, loga, dt, ssm0, Q):
    """The chunked scan. xh (B,S,H,p), Bc/Cc (B,S,N), loga/dt (B,S,H), ssm0
    (B,H,p,N), all fp32. Returns (y (B,S,H,p) without the D skip, final state)."""
    B, S = xh.shape[:2]
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        # zero log-decay and zero dt on the padded rows: they leave the state as it is
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bc, Cc = F.pad(Bc, (0, 0, 0, pad)), F.pad(Cc, (0, 0, 0, pad))
        loga, dt = F.pad(loga, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    h, ys = ssm0, []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, bq, cq, la, dtq = xh[:, sl], Bc[:, sl], Cc[:, sl], loga[:, sl], dt[:, sl]
        lc = torch.cumsum(la, dim=1)                             # (B,Q,H) cumulative log decay
        # intra-chunk: M[t,s] = exp(lc[t]-lc[s]) * (C_t.B_s) * dt_s, s<=t. Above the
        # diagonal rel >= 0 and exp(rel) may overflow: the where drops it before
        # any product, as in the reference
        rel = lc[:, :, None, :] - lc[:, None, :, :]              # (B,Q,Q,H)
        M = torch.where(tri[None, :, :, None], torch.exp(rel), 0.0)
        cb = torch.einsum("bqn,bsn->bqs", cq, bq)                # (B,Q,Q)
        M = M * cb[..., None] * dtq[:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", M, xq)
        # inter-chunk: y += C_t . (exp(lc[t]) h0); C.h first, so that no
        # (B,Q,H,p,N) product is formed
        y_inter = torch.einsum("bqn,bhpn->bqhp", cq, h) * torch.exp(lc)[..., None]
        # state update: h' = exp(lc[Q]) h0 + sum_s exp(lc[Q]-lc[s]) dt_s x_s B_s
        declast = torch.exp(lc[:, -1])                           # (B,H)
        w_s = torch.exp(lc[:, -1, None, :] - lc) * dtq           # (B,Q,H)
        h = h * declast[..., None, None] + torch.einsum(
            "bqhp,bqn->bhpn", w_s[..., None] * xq, bq)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_apply(params, x, cfg, *, state=None):
    """x: (B,S,d). state: None (train/prefill from zero) or decode state dict
    {"conv": (B,K-1,C), "ssm": (B,H,p,N)}. Returns (y, new_state); the new
    state's tensors are new (the one given is not written).

    Where the layout of ``parallel.ctx.model_parallel`` splits the heads,
    ``params`` holds this model rank's columns of ``in_proj`` and channels of
    the convolution (its heads' z, x and dt, and B and C whole:
    ``parallel.sharding.Segments``) and its heads of ``A_log``, ``D`` and
    ``dt_bias``: ``in_proj`` is a ``layers.split_mm`` product, the
    convolution and the SSD run on the rank's heads, and the heads' outputs
    and z are joined over ``model`` before the inner norm, which spans every
    head. The norm and the gate then run alike on every rank, and
    ``out_proj`` is ``layers.dense_columns`` where the layout splits
    ``d_model``. The state returned holds the rank's heads."""
    B, S, _ = x.shape
    N = cfg.ssm_state
    d_inner, p, H = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    dt_c = layers.to_dtype(cfg.compute_dtype)
    lay = pctx.layout()
    split = lay is not None and lay.ssm_heads

    if split:
        d_inner, H = d_inner // pctx.model_size(), H // pctx.model_size()
        zxbcdt = layers.dense_split(params["in_proj"], layers.split_input(x), dtype=dt_c)
    else:
        zxbcdt = layers.dense(params["in_proj"], x, dtype=dt_c)
    z, xc, Bc, Cc, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1).float()
    conv_out, conv_state = _causal_conv(
        conv_in, params["conv_w"], params["conv_b"],
        None if state is None else state["conv"])
    xc, Bc, Cc = torch.split(conv_out, [d_inner, N, N], dim=-1)

    # F.softplus returns its input above 20 where jax.nn.softplus adds
    # log1p(exp(-x)) < 2.1e-9: below half an fp32 ulp of any x > 20, so the two agree
    dt = F.softplus(dt.float() + params["dt_bias"])                   # (B,S,H)
    A = -torch.exp(params["A_log"])                                   # (H,) < 0
    loga = dt * A                                                     # (B,S,H) <= 0
    xh = xc.reshape(B, S, H, p)
    ssm0 = (x.new_zeros((B, H, p, N), dtype=torch.float32)
            if state is None else state["ssm"].float())

    if S == 1:  # decode fast path: h = a*h + dt*x (x) B ; y = h . C
        a = torch.exp(loga[:, 0])                                     # (B,H)
        dx = dt[:, 0, :, None] * xh[:, 0]                             # (B,H,p)
        h = ssm0 * a[..., None, None] + dx[..., None] * Bc[:, 0, None, None, :]
        y = torch.einsum("bhpn,bn->bhp", h, Cc[:, 0])
        y = y + params["D"][None, :, None] * xh[:, 0]
        y = y.reshape(B, 1, d_inner)
    else:
        y, h = _ssd_chunked(xh, Bc, Cc, loga, dt, ssm0, Q)
        y = y + params["D"][None, None, :, None] * xh
        y = y.reshape(B, S, d_inner)
    new_state = {"conv": conv_state, "ssm": h}

    y = y.to(dt_c)
    if split:
        y, z = pctx.gather_from_model(y, -1), pctx.gather_from_model(z, -1)
    y = layers.apply_norm("rmsnorm", params["norm"], y)
    y = y * F.silu(z.float()).to(dt_c)
    if split and lay.d_model:
        return layers.dense_columns(params["out_proj"], y, dtype=dt_c), new_state
    return layers.dense(params["out_proj"], y, dtype=dt_c), new_state


def mamba_state_init(cfg, batch, *, device):
    """A zero decode state, fp32 whatever the compute type."""
    d_inner, p, H = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state), **f32),
        "ssm": torch.zeros((batch, H, p, cfg.ssm_state), **f32),
    }
