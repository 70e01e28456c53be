"""Plain reference of the dense decoder-only LM the port serves and trains.

Written from the configuration file's keys and the published architecture as
the port runs it (the file's ``departures`` say where that differs from the
published model): a sequential pre-norm block, LayerNorm with a scale and a
bias or without parameters (eps ``layer_norm_eps``), rotary embeddings with
the half rotation at ``rope_theta`` on q and k, grouped-query causal
attention scaled by ``1/sqrt(head_dim)``, a SwiGLU MLP, a final norm and the
tied embedding as the output head. Every product is float32 with TF32 off
(``no_tf32``). It reads the parameters as a tree of the benchmark's tensors
laid out as the port lays them out (``emb.table``, ``blocks[i].attn.wq.w``
``(d_in, d_out)``, ...), widening each layer's weights to float32 when it
gets to that layer, and it imports nothing of the program.

``precision="fp8"`` is the control: every weight product takes its two
operands rounded to float8 e4m3 (one scale a tensor, its largest magnitude
at 448) and multiplies them in float32, the step below the configuration's
bfloat16; attention and the norms stay float32. Under autograd the rounding
passes the gradient straight through, so the backward products take the
rounded operands too.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

E4M3_MAX = 448.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale, back in float32; the
    gradient passes straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach() if t.requires_grad else q


def matmul(x, w, precision: str):
    if precision == "fp32":
        return x @ w
    if precision == "fp8":
        return fp8(x) @ fp8(w)
    raise ValueError(precision)


def norm(c: Dict, p, x):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + c["layer_norm_eps"])
    if c["norm"] == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    elif c["norm"] != "nonparametric":
        raise ValueError(c["norm"])
    return y


def rope(x, positions, theta: float):
    """x (S, heads, D), positions (S,): the half rotation."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(0, half, dtype=torch.float32,
                                                      device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, rows: int = 1024):
    """Causal attention of one sequence: q (S, H, D), k/v (S, Hkv, D), in
    blocks of query rows."""
    S, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(S, Hkv, G, D)
    out = []
    for r0 in range(0, S, rows):
        qb = qg[r0:r0 + rows]
        n = qb.shape[0]
        s = torch.einsum("rhgd,shd->hgrs", qb, k[:r0 + n]) / math.sqrt(D)
        keep = torch.arange(r0 + n, device=q.device)[None, :] <= \
            torch.arange(r0, r0 + n, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out.append(torch.einsum("hgrs,shd->rhgd", p, v[:r0 + n]).reshape(n, H * D))
    return torch.cat(out)


def block(c: Dict, p, x, positions, precision: str):
    """One layer on one sequence x (S, d), float32."""
    S = x.shape[0]
    H, Hkv, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    a = p["attn"]
    h = norm(c, p["attn_norm"], x)
    q = matmul(h, a["wq"]["w"], precision).reshape(S, H, D)
    k = matmul(h, a["wk"]["w"], precision).reshape(S, Hkv, D)
    v = matmul(h, a["wv"]["w"], precision).reshape(S, Hkv, D)
    q, k = rope(q, positions, c["rope_theta"]), rope(k, positions, c["rope_theta"])
    x = x + matmul(attention(q, k, v), a["wo"]["w"], precision)
    h = norm(c, p["mlp_norm"], x)
    m = p["mlp"]
    g = F.silu(matmul(h, m["wg"]["w"], precision)) * matmul(h, m["wu"]["w"], precision)
    return x + matmul(g, m["wd"]["w"], precision)


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    return tree.float()


# ---------------------------------------------------------------------------
# serving: the logits of served tokens
# ---------------------------------------------------------------------------

@torch.no_grad()
def served_gaps(c: Dict, params, requests: Sequence[Tuple[Sequence[int], Sequence[int]]],
                control: bool = False, vocab_rows: int = 16384) -> Dict[str, List[List[float]]]:
    """For each request ``(prompt, served)``: the gap by which each served
    token's logit lies below the best logit, in the float32 reference run over
    the sequence the engine decoded (the prompt, its last token again, then
    every served token but the last; the i-th served token is read at
    position ``len(prompt) + i``). With ``control``, also the gap of the
    token the fp8 control puts first at each of those positions.

    Layer by layer: each layer's weights are widened once and applied to
    every request."""
    no_tf32()
    table = params["emb"]["table"]
    dev = table.device
    seqs = [torch.tensor(list(p) + [p[-1]] + list(s[:-1]), dtype=torch.long, device=dev)
            for p, s in requests]
    pos = [torch.arange(len(t), device=dev) for t in seqs]
    streams = {"fp32": [table[t].float() for t in seqs]}
    if control:
        streams["fp8"] = [h.clone() for h in streams["fp32"]]
    for blk in params["blocks"]:
        w = _fp32(blk)
        for prec, hs in streams.items():
            for i, h in enumerate(hs):
                hs[i] = block(c, w, h, pos[i], prec)
        del w
    fin = _fp32(params["final_norm"])
    sel = {prec: torch.cat([norm(c, fin, h[len(p):]) for h, (p, _) in zip(hs, requests)])
           for prec, hs in streams.items()}
    served = torch.tensor([t for _, s in requests for t in s], dtype=torch.long, device=dev)
    rows = sel["fp32"].shape[0]
    best = torch.full((rows,), float("-inf"), device=dev)
    at_served = torch.empty(rows, device=dev)
    ctrl_best = torch.full((rows,), float("-inf"), device=dev)
    ctrl_tok = torch.zeros(rows, dtype=torch.long, device=dev)
    for v0 in range(0, table.shape[0], vocab_rows):
        tw = table[v0:v0 + vocab_rows].float().T
        logits = sel["fp32"] @ tw
        best = torch.maximum(best, logits.amax(dim=1))
        mine = (served >= v0) & (served < v0 + tw.shape[1])
        idx = torch.nonzero(mine)[:, 0]
        at_served[idx] = logits[idx, served[idx] - v0]
        if control:
            lc = matmul(sel["fp8"], tw, "fp8")
            val, arg = lc.max(dim=1)
            upd = val > ctrl_best
            ctrl_best = torch.where(upd, val, ctrl_best)
            ctrl_tok = torch.where(upd, arg + v0, ctrl_tok)
    out = {"gaps": _split(best - at_served, requests)}
    if control:
        at_ctrl = (sel["fp32"] * table[ctrl_tok].float()).sum(dim=1)
        out["control_gaps"] = _split(best - at_ctrl, requests)
    return out


@torch.no_grad()
def logits(c: Dict, params, tokens, precision: str = "fp32"):
    """Float32 logits (S, V) of one sequence of tokens (S,)."""
    no_tf32()
    x = params["emb"]["table"][tokens].float()
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    for blk in params["blocks"]:
        x = block(c, _fp32(blk), x, positions, precision)
    x = norm(c, _fp32(params["final_norm"]), x)
    return matmul(x, params["emb"]["table"].float().T, precision)


def _split(x, requests):
    out, at = [], 0
    for _, s in requests:
        out.append(x[at:at + len(s)].tolist())
        at += len(s)
    return out


# ---------------------------------------------------------------------------
# training: three AdamW steps
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def lm_loss_sum(c: Dict, params, tokens, labels, precision: str):
    """Summed next-token cross entropy of one sequence (float32 logits)."""
    table = params["emb"]["table"]
    x = table[tokens]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    for blk in params["blocks"]:
        x = torch.utils.checkpoint.checkpoint(block, c, blk, x, positions, precision,
                                              use_reentrant=False)
    x = norm(c, params["final_norm"], x)
    logits = matmul(x, table.T, precision)
    return F.cross_entropy(logits, labels.long(), reduction="sum")


def lr_at(o: Dict, step: int) -> float:
    """The warmed-up cosine schedule at ``step`` (1-based)."""
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    t = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    cos = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * t))
    return o["lr"] * warm * cos


def decays(path) -> bool:
    """AdamW's weight decay: not on biases and norm scales; a leaf counts as
    the model stacks it, a layer's 1-d leaf as 2-d."""
    return path[-1] not in ("b", "scale", "bias")


def train_steps(c: Dict, params, batches, o: Dict, precision: str = "fp32") -> Dict:
    """Three (or ``len(batches)``) AdamW steps of the float32 model from
    ``params`` (float32 leaves, changed in place), each batch ``(tokens,
    labels)`` (B, S), its loss the mean over every token, taken one
    sequence at a time. Returns each step's loss, the first step's clipped
    gradient (the gradient as the optimizer takes it) and the change of each
    leaf after the last step, each leaf's norm, by the leaves' paths."""
    no_tf32()
    named = _leaves(params)
    ps = [p.requires_grad_(True) for _, p in named]
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    p0 = [p.detach().clone() for p in ps]
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        grads = [torch.zeros_like(p) for p in ps]
        total = tokens.numel()
        loss = 0.0
        for r in range(tokens.shape[0]):
            part = lm_loss_sum(c, params, tokens[r], labels[r], precision) / total
            gs = torch.autograd.grad(part, ps)
            for acc, g in zip(grads, gs):
                acc.add_(g)
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
            scale = min(o["clip_norm"] / max(gnorm, 1e-9), 1.0)
            grads = [g * scale for g in grads]
            if first is None:
                first = [float(g.norm()) for g in grads]
            lr = lr_at(o, step)
            b1, b2 = o["beta1"], o["beta2"]
            for (path, _), p, g, mi, vi in zip(named, ps, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (mi / (1 - b1 ** step)) / ((vi / (1 - b2 ** step)).sqrt() + o["eps"])
                if decays(path) and o["weight_decay"]:
                    delta = delta + o["weight_decay"] * p
                p.sub_(lr * delta)
    with torch.no_grad():
        change = [float((p - q).norm()) for p, q in zip(ps, p0)]
    paths = ["/".join(map(str, path)) for path, _ in named]
    return {"losses": losses, "first_grad_norms": dict(zip(paths, first)),
            "change_norms": dict(zip(paths, change))}
