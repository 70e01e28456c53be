"""FlashAttention forward: wrappers of the hand-written Hopper kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_flash_fwd_kernel`` / ``flash_attention``). A CUDA tensor is routed by dtype:

- bf16 goes to ``csrc/flash_fwd_sm90.cu``: a warp-specialised kernel in the
  shape of ``core/kprog/fa3.py`` (a producer warpgroup keeping a ring of K/V
  stages in flight with TMA, two consumer warpgroups of 64 query rows taking
  turns at ``wgmma`` for Q·Kᵀ and P·V, the online softmax in registers). P goes
  into P·V as bf16, as in FA3; the TPU kernel keeps it fp32 (the plain version's
  ``pv_bf16=True`` mirrors the kernel). TMA reads the tensors in place, so a
  bf16 tensor it cannot address (base not 16-byte aligned, a stride that is not
  a multiple of 16 bytes) raises ``ValueError``: nothing falls back.
- fp32 goes to ``csrc/flash_fwd.cu``: fp32 FMAs (``wgmma`` has no fp32 input,
  and TF32 would not agree with an fp32 reference to 2e-5), register-tiled, a
  2-stage K/V ring filled by 16-byte ``cp.async`` copies, and causal row tiles
  paired so that every block of a head walks as many K/V tiles (the source's
  header states the schedule). The copies need the same addressability as
  TMA, so an fp32 tensor that fails it raises ``ValueError`` too.

At serving shapes the bf16 call's byte and tensor-core bounds are about equal
(1.4 and 1.1 microseconds); the fp32 call is bound by the fp32 FMA rate
(16 microseconds).

The public layout is the TPU kernel's, q ``(B, H, L, D)`` and k/v
``(B, Hkv, S, D)``, but the tensors may be strided views (only D has to be
contiguous): both kernels take strides, so ``ops.mha_forward`` passes
transposed views of the model-side ``(B, L, H, D)`` tensors and nothing is
copied or padded.

``stages`` is the bf16 kernel's tiling parameter, the counterpart of the TPU
kernel's ``block_q`` / ``block_k``: the depth of its K/V ring. ``None`` takes the
kernel's default (2 above head_dim 64, 4 at 64 and below); the built variants
are ``STAGES_SM90``. Any other value, or a ``stages`` with fp32 tensors, raises
``ValueError`` on every device, so a setting the kernel would refuse fails on
the CPU too. The ring's depth changes no arithmetic: the plain version checks
it and computes as ever.

A meta tensor takes neither: the wrapper returns an empty meta output and
launches nothing (the backward likewise returns empty gradients). While a
``utils.cost.CostCounter`` is active, a call records one kernel
(``forward_flops``: the reference's count of ``flash_ref``) and the backward
one ``flash_attention_bwd`` of twice those FLOPs (the four products of the two
einsums' gradients); nothing beneath either is counted again.

A CPU tensor takes ``flash_attention_plain``. ``launches_sm90`` and
``launches_f32`` count the launches of each kernel, ``launches`` their sum;
nothing else moves them.

``FlashAttentionFn`` makes the forward differentiable. Its forward is
``flash_attention`` (the kernel on a CUDA tensor, the plain version on a CPU
one); its backward recomputes ``flash_attention_plain`` from the saved q, k and
v under autograd and returns the gradient of that. The recompute rounds P as
the forward did: with ``pv_bf16`` for a bf16 CUDA tensor (the bf16 kernel
rounds P), in fp32 for every other (the plain forward keeps P fp32). The backward is plain PyTorch on purpose: the
JAX package has no backward kernel either, its gradient is XLA's autodiff of
the jnp ``flash_ref``. Under ``torch.utils.checkpoint`` the forward runs again
in the backward pass, and that launch is counted like any other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import tma_addressable as _tma_addressable
from repro_torch.utils import cost

NEG_INF = -1e30
DEFAULT_BLOCK_K = 128
# csrc/flash_fwd_sm90.cu: the K/V ring depths built for each head-dim template
# (D > 64 runs the 128-column one), and the one a call takes by default
STAGES_SM90 = {128: (2, 3), 64: (2, 3, 4)}
DEFAULT_STAGES_SM90 = {128: 2, 64: 4}
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0        # kernel launches made by ``flash_attention``, both routes
launches_sm90 = 0   # of which bf16, csrc/flash_fwd_sm90.cu
launches_f32 = 0    # of which fp32, csrc/flash_fwd.cu
_fn = None
_fn_sm90 = None


def head_dim_template(D: int) -> int:
    """The head-dim template of csrc/flash_fwd_sm90.cu that runs head_dim ``D``."""
    return 128 if D > 64 else 64


def check_stages(stages, D: int, dtype) -> None:
    """Raise ``ValueError`` unless the bf16 kernel has a variant of ``stages``
    for head_dim ``D`` (``None``, the default, always passes)."""
    if stages is None:
        return
    if dtype != torch.bfloat16:
        raise ValueError(f"stages is the bf16 kernel's ring depth; got {dtype} tensors")
    built = STAGES_SM90[head_dim_template(D)] if D <= 128 else ()
    if isinstance(stages, bool) or not isinstance(stages, int) or stages not in built:
        raise ValueError(f"the bf16 forward at head_dim {D} is built with stages in "
                         f"{built}, got {stages!r}")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_k: int = DEFAULT_BLOCK_K, pv_bf16: bool = False,
                          stages=None):
    """Plain PyTorch version of the kernels: same arithmetic, same layout.

    Online softmax over KV tiles of ``block_k`` with fp32 ``(acc, m, l)``, the
    ``-1e30`` sentinel, ``acc / max(l, 1e-30)`` at the end. P stays fp32 into
    P·V, as in the TPU kernel and the fp32 kernel; ``pv_bf16`` rounds P and V
    to bf16 before P·V (the row sums keep fp32 P), as the bf16 kernel does and
    as ``repro.models.attention.flash_ref(pv_bf16=True)`` does. ``stages`` is
    checked as the kernel checks it and changes nothing else.
    """
    check_stages(stages, q.shape[-1], q.dtype)
    B, H, L, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, L, D).float()
    rows = torch.arange(L, device=q.device)[:, None]
    m = torch.full((B, Hkv, G, L), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, L, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, block_k):
        kj = k[:, :, k0:k0 + block_k].float()
        vj = v[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bhgld,bhsd->bhgls", qg, kj) * scale
        if causal:
            cols = k0 + torch.arange(kj.shape[2], device=q.device)[None, :]
            s = torch.where(cols > rows, torch.full_like(s, NEG_INF), s)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        m = m_new
        if pv_bf16:
            p, vj = p.bfloat16().float(), vj.bfloat16().float()
        acc = acc * corr[..., None] + torch.einsum("bhgls,bhsd->bhgld", p, vj)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, L, D).to(q.dtype)


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("flash_fwd").repro_flash_fwd
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p] + [i] * 6 + [i64] * 12 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _entry_sm90():
    global _fn_sm90
    if _fn_sm90 is None:
        fn = _build.load("flash_fwd_sm90").repro_flash_fwd_sm90
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p] + [i] * 6 + [i64] * 12 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        _fn_sm90 = fn
    return _fn_sm90


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,H,L,D) and k/v (B,Hkv,S,D)")
    B, H, L, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % k.shape[1] != 0:
        raise ValueError(f"{H} query heads do not group over {k.shape[1]} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, all "
                        f"alike; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.device != q.device:
            raise ValueError("q, k and v must lie on one device")


def forward_flops(q, k) -> int:
    """The forward's FLOPs as the reference counts its jnp counterpart
    (``flash_ref``): the full ``L x S`` products over S padded to whole
    chunks of ``min(512, S)``, no masked block skipped."""
    B, H, L, D = q.shape
    S = k.shape[2]
    chunk = min(512, S)
    return 4 * B * H * L * (-(-S // chunk) * chunk) * D


def _fwd_counts(q, k, v):
    """The forward's record: q, k and v read, o (q's size) written."""
    return forward_flops(q, k), sum(map(cost.nbytes, (q, k, v, q)))


def _bwd_counts(q, k, v, grad_o):
    """The backward's record: the four products of the two einsums'
    gradients, counted once; q, k, v and grad_o read, their gradients
    written."""
    return 2 * forward_flops(q, k), sum(map(cost.nbytes, (q, k, v, grad_o, q, k, v)))


def flash_attention(q, k, v, *, causal: bool = True, stages=None):
    """q: (B, H, L, D); k/v: (B, Hkv, S, D) -> (B, H, L, D), strides kept."""
    global launches, launches_sm90, launches_f32
    _check(q, k, v)
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("the causal mask has no query offset: it needs L == S, "
                         f"got L={q.shape[2]}, S={k.shape[2]}")
    check_stages(stages, q.shape[3], q.dtype)
    with cost.kernel("flash_attention", _fwd_counts, q, k, v):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal)
        if q.device.type == "meta":           # shapes only: nothing to launch
            return torch.empty_like(q)
        if q.device.type != "cuda":
            raise RuntimeError(f"flash_attention has no kernel for {q.device}")
        o = _launch(q, k, v, causal, stages)
    if q.dtype == torch.bfloat16:
        launches_sm90 += 1
    else:
        launches_f32 += 1
    launches += 1
    return o


def _launch(q, k, v, causal, stages=None):
    """The CUDA route: checks what the kernels take, then launches one of them."""
    B, H, L, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if D > 128:
        raise ValueError(f"flash_attention kernel supports head_dim <= 128, got {D}")
    # same strides as q when q is a dense view, so a transposed view of a
    # (B, L, H, D) tensor gives an output that transposes back for free
    o = torch.empty_like(q)
    if o.stride(3) != 1:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    sm90 = q.dtype == torch.bfloat16
    how = ("the bf16 kernel reads and writes through TMA" if sm90 else
           "the fp32 kernel moves 16-byte chunks (cp.async copies, float4 stores)")
    for name, t in (("q", q), ("k", k), ("v", v), ("the output", o)):
        if not _tma_addressable(t):
            raise ValueError(f"{name}: {how}, which needs a 16-byte aligned base and "
                             f"strides that are multiples of 16 bytes; got strides "
                             f"{t.stride()} at {t.data_ptr():#x}")
    args = (B, H, Hkv, L, S, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            1.0 / math.sqrt(D), int(causal))
    if sm90:
        args += (stages or 0,)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = (_entry_sm90() if sm90 else _entry())(*ptrs, *args, stream)
    _build.check(err, "flash_fwd_sm90" if sm90 else "flash_fwd")
    return o


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward takes the tensor's route
    (kernel or plain), the backward is autograd of the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, stages):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal=causal, stages=stages)

    @staticmethod
    def backward(ctx, grad_o):
        q, k, v = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        with cost.kernel("flash_attention_bwd", _bwd_counts, q, k, v, grad_o):
            if q.device.type == "meta":       # shapes only, laid out as autograd's
                return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) if w
                             else None for t, w in zip((q, k, v), want)) + (None, None)
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(w) for t, w in zip((q, k, v), want)]
                o = flash_attention_plain(*ins, causal=ctx.causal,
                                          pv_bf16=q.dtype == torch.bfloat16 and q.is_cuda)
                got = iter(torch.autograd.grad(o, [t for t, w in zip(ins, want) if w],
                                               grad_o))
        return tuple(next(got) if w else None for w in want) + (None, None)
