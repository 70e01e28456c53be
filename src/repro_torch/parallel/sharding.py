"""Sharding rules: parameter, optimizer-state, batch and cache partitioning,
held exactly to the JAX package's rules.

Strategy (the reference's):
  * ``model`` axis = tensor parallel (heads, d_ff, vocab, experts-or-ff);
  * ``data`` (+ ``pod`` when present) = batch DP **and** FSDP-style sharding
    of parameters and optimizer state;
  * MoE expert weights choose EP (experts over 'model') when E divides the
    axis, else TP within experts;
  * KV caches shard heads over 'model'; long-context (batch 1) caches shard
    the *sequence* over 'data'.

A spec is the reference's ``PartitionSpec`` written as a plain tuple, so it
compares equal to ``tuple(P(...))``: one entry a tensor dim, each ``None``, an
axis name or a tuple of axis names. ``placements`` turns one into ``DTensor``
placements on a ``DeviceMesh`` (the reference's ``NamedSharding``).

The port's tree differs from the reference's, and the rules follow it. The
reference stacks each layer's leaves along leading dims (``blocks``,
``prologue``, ``enc_blocks``, ``dec_blocks`` on one, hybrid ``groups`` on two);
the port keeps lists of per-layer dicts (``transformer.JAX_STACKED_DIMS``). The
path a rule sees is the reference's path with the list positions left out, and
a leaf inside a layer list gets the reference's spec without the leading
``None`` of each stacking dim.

The placements at rest are the reference's; the layout the sharded train
step **computes** in over ``model`` is the port's own choice, and
``model_layout`` is its one owner: the trainer places each leaf by
``compute_layout`` (which reads it) and the layers split their products as it
says (``parallel.ctx.layout()``). GSPMD resolves the same situations with
reshards of its own. tp is the ``model`` axis's size. Every partitioned
product is column-parallel: each rank computes whole output columns, over the
whole contraction, as one device does. The second product of a pair (``wo``,
the MLP's and an expert's ``wd``) takes its input's blocks gathered over
``model`` and its output columns (``d_model``) split, not its rows as at
rest; the ranks' column blocks are then joined (``layers.dense_joined``). A
sum of per-rank partial products in their place (Megatron's row-parallel
product) would reassociate the residual stream, and C13's bf16 roundings in
the loss turn that into gradient noise that moves Adam's steps on near-zero
gradients past the 1e-5 parity with one device (ROADMAP C32).
  * q heads: where ``H % tp == 0`` each rank computes its ``H/tp`` q heads
    (``wq`` and its bias).
  * kv heads: where also ``Hkv % tp == 0``, the kv heads its q heads map to
    (``h -> h // G``), which are its ``wk`` / ``wv`` shard. Where
    ``Hkv % tp != 0`` (a shard of ``wk`` would be a fraction of a kv head, or
    split one head's columns), ``wk`` / ``wv`` and their biases are gathered
    over ``model`` for compute, and each rank takes the kv heads its q heads
    need; each rank's gradient of the gathered leaf is then a partial sum,
    whatever the placements at rest.
  * whole attention: where ``H % tp != 0`` (a ``wq`` shard is not a whole
    number of heads), the four projections are gathered over ``model`` and
    the attention runs alike on every model rank.
  * ``d_ff``, the vocabulary, the experts (EP, where ``E % tp == 0``) or each
    expert's ``d_ff`` (TP within the experts) are split where tp divides
    them, else computed whole on every rank (minicpm's odd vocabulary
    122753). The second product of a pair splits its output columns only
    where tp divides ``d_model``; else every rank computes all of them.
  * Mamba2 (hybrid) and RWKV6 (ssm) heads: where tp divides them, each rank
    computes its block of the heads. A Mamba2 layer's ``in_proj`` fuses
    z, x, B, C and dt: each rank takes the z, x and dt columns of its heads
    and the B and C columns whole (``Segments``; every head reads B and C, so
    each rank's gradient of those columns is a partial sum), its
    convolution's x channels likewise, and ``A_log`` / ``D`` / ``dt_bias``
    by heads. The inner RMSNorm spans every head, so the heads' outputs and
    z are joined over ``model`` before it; the norm and the gate run alike
    on every rank and ``out_proj`` computes this rank's ``d_model`` columns
    of the joined input (``layers.dense_columns``). RWKV6's time mix splits
    ``wr`` / ``wk`` / ``wv`` / ``wg``, the decay (``decay`` and
    ``decay_w2``'s columns), ``u``, the WKV scan and the per-head ``ln_x``
    by heads; its token-shift mixes and LoRA's first products are computed
    alike on every rank, and ``wo`` is a pair's second product. Its channel
    mix splits ``wk`` by ``d_ff``; ``wv`` is the pair's second product, and
    ``wr`` splits on the output columns ``wv`` gives the rank, the gate
    applied before the join.
  * everything else (norms, the router, the residual, ``pos_dec``) computes
    whole, alike on every model rank.
  * under sequence parallelism (``compute_layout(..., seq=True)``, every
    family, ``trainer.seq_parallel``) each rank applies the norms (the
    blocks', the hybrid's outer layer norms, RWKV6's ``ln0`` / ``ln1`` /
    ``ln2``, whisper's ``enc_norm`` / ``dec_norm``), the bias of a pair's
    second product and a whole MLP (``d_ff`` unsplit) to its own rows of the
    residual, and the MoE router to its rows' tokens, so its gradient of
    those replicated leaves is a partial sum; the whole attention, the
    experts, an unsplit vocabulary, ``pos_dec`` (added to the whole sequence
    before the rows are taken) and the token mixers' replicated leaves
    (Mamba2's inner norm, RWKV6's token-shift mixes and LoRAs) still run
    alike on the gathered sequence (``_compute_leaf``'s table, next to each
    leaf's split). An encoder's leaves (``STACK_LEAVES``) follow its own
    stack's answer.

The serving steps (``serve.decode``'s ``mesh=``, every family) hold each
bf16 leaf in its ``compute_layout`` over ``model`` and whole over the data
axes (``serve_specs``; ROADMAP C42), a ``Segments`` leaf rank-major
(``rank_major``, C43). Each rank's block of a K/V stack placed by
``cache_specs`` is a ``CacheBlock`` (``cache_block``): its batch rows, its
kv heads, its block of the sequence, and an encoder-decoder's block of its
cross cache; ``serve_cache_specs`` places every leaf of a cache, the
per-layer states too.

The rules read the axis sizes by name. They take a ``DeviceMesh`` with named
dims, or any object with a dict ``.shape`` and ``.axis_names`` (a stand-in for
a mesh too large to build, as the planning tests use).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch import tree


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the sharding rules need a DeviceMesh with named dims")
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order."""
    if isinstance(mesh, DeviceMesh):
        return {n: mesh.size(i) for i, n in enumerate(axis_names(mesh))}
    return {a: mesh.shape[a] for a in mesh.axis_names}


def is_spec(x) -> bool:
    """The leaves of a spec or placements tree: plain tuples (a tree's own
    sequences are lists, dicts or NamedTuples). Hand it to ``tree``'s
    ``is_leaf``."""
    return type(x) is tuple


def fsdp_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def fsdp_size(mesh) -> int:
    """The product of the fsdp axes' sizes: the data ranks a batch splits over."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in fsdp_axes(mesh):
        n *= sizes[a]
    return n


def _rule(path: str, ndim: int, cfg, moe_sharding: str) -> Tuple:
    """Spec for the unstacked (per-layer) leaf."""
    f = "F"   # placeholder: fsdp axes
    t = "model"

    def last(name):
        return path.endswith(name) or path.endswith(name + "/w")

    # --- MoE expert tensors (E, d, ff) / (E, ff, d)
    if "/moe/" in path:
        if last("router"):
            return (f, None)
        ep = moe_sharding == "ep"
        if last("wg") or last("wu"):
            return (t, f, None) if ep else (None, f, t)
        if last("wd"):
            return (t, None, f) if ep else (None, t, f)

    # --- attention projections
    if re.search(r"/(attn|xattn)/w[qkv]/w$", path):
        return (f, t)
    if re.search(r"/(attn|xattn)/w[qkv]/b$", path):
        return (t,)
    if re.search(r"/(attn|xattn)/wo/w$", path):
        return (t, f)
    if re.search(r"/(attn|xattn)/wo/b$", path):
        return (None,)

    # --- dense mlp
    if re.search(r"/mlp/w[gu]/w$", path):
        return (f, t)
    if re.search(r"/mlp/w[gu]/b$", path):
        return (t,)
    if re.search(r"/mlp/wd/w$", path):
        return (t, f)
    if re.search(r"/mlp/wd/b$", path):
        return (None,)

    # --- mamba
    if "/mamba/" in path:
        if last("in_proj"):
            return (f, t)
        if last("out_proj"):
            return (t, f)
        if path.endswith("conv_w"):
            return (None, t)
        if path.endswith(("conv_b",)):
            return (t,)
        if path.endswith(("A_log", "D", "dt_bias")):
            return (None,)
        if "/norm/" in path:
            return (t,)

    # --- rwkv
    if "/tmix/" in path or "/cmix/" in path:
        if re.search(r"/w[rkvg]/w$", path) or last("wk") or last("wr"):
            return (f, t)
        if re.search(r"/(wo|wv)/w$", path):
            return (t, f)
        if path.endswith("maa_w1") or path.endswith("decay_w1"):
            return (f, None)
        if path.endswith("maa_w2"):
            return (None, None, f)
        if path.endswith("decay_w2"):
            return (None, f)
        if path.endswith("u"):
            return (t, None)
        if path.endswith("decay"):
            return (f,)
        if "/ln_x/" in path:
            return (t,)
        return tuple(None for _ in range(ndim))

    # --- embeddings / unembed
    if path.endswith("emb/table"):
        return (t, f)
    if path.endswith("unembed/w"):
        return (f, t)
    if path.endswith("unembed/b"):
        return (t,)
    if path.endswith("pos_dec"):
        return (None, f)

    # norms and anything residual-dim shaped: replicate
    return tuple(None for _ in range(ndim))


def _materialize(spec_tuple, mesh) -> Tuple:
    fa = fsdp_axes(mesh)
    out = []
    for s in spec_tuple:
        if s == "F":
            out.append(fa if len(fa) > 1 else fa[0])
        else:
            out.append(s)
    return tuple(out)


def sanitize_spec(spec, shape, mesh) -> Tuple:
    """Drop sharding on dims whose size doesn't divide the axis product
    (e.g. odd vocabularies, KV-head counts below the TP degree)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        out.append(s if shape[i] % prod == 0 else None)
    return tuple(out)


def param_specs(cfg, params_shape, mesh, *, moe_sharding: str = "auto"):
    """Spec tree matching ``params_shape`` (tensors, meta tensors or anything
    with a ``.shape``); its leaves are tuples (``is_spec``)."""
    if moe_sharding == "auto":
        msize = axis_sizes(mesh)["model"]
        moe_sharding = "ep" if (cfg.num_experts and
                                cfg.num_experts % msize == 0) else "tp"

    def spec(path_elems, leaf):
        # a list position is a layer of a stack the reference keeps as leading dims
        path = "/".join(str(p) for p in path_elems if not isinstance(p, int))
        ndim = len(leaf.shape)
        base = tuple(_rule(path, ndim, cfg, moe_sharding))
        if len(base) != ndim:   # fallback: replicate
            base = (None,) * ndim
        return sanitize_spec(_materialize(base, mesh), leaf.shape, mesh)

    return tree.rebuild(params_shape, [spec(p, leaf) for p, leaf in
                                       tree.leaves_with_paths(params_shape)])


@dataclass(frozen=True)
class ModelLayout:
    """How the sharded train step splits a model's products over ``model``
    (the module's docstring): each flag says whether tp divides that dim,
    which each rank then computes its share of."""
    heads: bool          # q heads
    kv_heads: bool       # kv heads too
    d_ff: bool           # the MLP's hidden units
    d_model: bool        # the output columns of a pair's second product
    vocab: bool
    experts: str         # "ep", "tp" (each expert's d_ff) or "none"
    ssm_heads: bool = False   # Mamba2's (hybrid) or RWKV6's (ssm) heads


MAMBA_HEAD_DIM = 64      # models/mamba.py's Mamba2 head dim


def ssm_heads(cfg) -> int:
    """The heads of a hybrid model's Mamba2 layers or an ssm model's RWKV6
    layers (0 for the other families)."""
    if cfg.family == "hybrid":
        return cfg.ssm_expand * cfg.d_model // MAMBA_HEAD_DIM
    if cfg.family == "ssm":
        return cfg.d_model // cfg.rwkv_head_dim
    return 0


def model_layout(cfg, tp: int) -> ModelLayout:
    """The compute layout of ``cfg`` over ``tp`` model ranks."""
    heads = bool(cfg.num_heads) and cfg.num_heads % tp == 0
    experts = "none"
    if cfg.num_experts:
        experts = ("ep" if cfg.num_experts % tp == 0
                   else "tp" if cfg.d_ff % tp == 0 else "none")
    n_ssm = ssm_heads(cfg)
    return ModelLayout(heads=heads, kv_heads=heads and cfg.num_kv_heads % tp == 0,
                       d_ff=cfg.d_ff % tp == 0, d_model=cfg.d_model % tp == 0,
                       vocab=cfg.vocab_size % tp == 0, experts=experts,
                       ssm_heads=bool(n_ssm) and n_ssm % tp == 0)


@dataclass(frozen=True)
class Segments:
    """A spec entry for a dim that joins segments of ``sizes`` columns: over
    ``model`` each rank takes its block of every segment whose ``split`` is
    set and the others whole, in order (a Mamba2 layer's fused ``in_proj``:
    z, x, B, C, dt).

    No ``Shard`` placement describes such a dim, since the whole segments
    are on every rank. A serving replica holds the leaf **rank-major**: the
    ranks' blocks (``take``) joined in rank order, a ``Shard`` of that
    tensor over ``model`` (``serve_specs``; ROADMAP C43). ``to_rank_major``
    and ``to_one_device`` map between the two layouts; at tp 1 both are the
    identity."""
    sizes: Tuple[int, ...]
    split: Tuple[bool, ...]

    def block_size(self, tp: int) -> int:
        """The columns of one rank's block."""
        return sum(size // tp if split else size for size, split in zip(self.sizes, self.split))

    def take(self, t, dim: int, tp: int, rank: int):
        """Model rank ``rank``'s columns of ``t`` (the whole dim) along ``dim``."""
        if tp == 1:
            return t
        parts, start = [], 0
        for size, split in zip(self.sizes, self.split):
            n = size // tp if split else size
            parts.append(t.narrow(dim, start + (rank * n if split else 0), n))
            start += size
        return torch.cat(parts, dim=dim)

    def to_rank_major(self, t, dim: int, tp: int):
        """``t`` (the one-device layout of the dim) as the ranks' blocks
        joined in rank order: ``tp * block_size(tp)`` columns."""
        if tp == 1:
            return t
        return torch.cat([self.take(t, dim, tp, r) for r in range(tp)], dim=dim)

    def to_one_device(self, t, dim: int, tp: int):
        """The inverse of ``to_rank_major``: the split segments' blocks joined
        in rank order, a whole segment taken from rank 0's block."""
        if tp == 1:
            return t
        blocks, parts, start = t.chunk(tp, dim=dim), [], 0
        for size, split in zip(self.sizes, self.split):
            n = size // tp if split else size
            parts.extend(b.narrow(dim, start, n) for b in (blocks if split else blocks[:1]))
            start += n
        return torch.cat(parts, dim=dim)


def conv_segments(cfg) -> Segments:
    """The channels of a Mamba2 layer's convolution (its ``conv_w``,
    ``conv_b`` and decode state): x by heads, B and C whole."""
    N = cfg.ssm_state
    return Segments((cfg.ssm_expand * cfg.d_model, N, N), (True, False, False))


_COMPUTE_LEAF = re.compile(r"(attn/w[qkvo]|mlp/w[gud]|moe/w[gud]|moe/router|emb/table|unembed"
                           r"|attn_norm|mlp_norm|final_norm|(?:prologue|groups)/norm|ln[012]"
                           r"|enc_norm|dec_norm)(?:/(\w+))?$")
# the leaves of each stack whose sequence splits by its own length
# (``parallel.ctx.stack``): an encoder-decoder's encoder (the frames)
STACK_LEAVES = {"encoder": ("enc_blocks/", "enc_norm/")}
# an RWKV6 layer's leaves that split by heads, and the dim of each
_RWKV_HEADS = re.compile(r"tmix/(?:(w[rkvg]/w|decay_w2)|(decay|u|ln_x/scale|ln_x/bias))$")


def _columns(ndim, dim=None):
    """A spec over ``model`` splitting ``dim`` (the last by default)."""
    dim = ndim - 1 if dim is None else dim
    return tuple("model" if i == dim else None for i in range(ndim))


def _ssm_leaf(lay: ModelLayout, cfg, path: str, ndim: int):
    """(spec, gradient kind) of a Mamba2 or RWKV6 leaf, or ``None`` for
    another leaf (``_compute_leaf``)."""
    whole = ((None,) * ndim, "same")
    if "/mamba/" in path:
        if not lay.ssm_heads:
            return whole
        d_inner, N, H = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, ssm_heads(cfg)
        if path.endswith("in_proj/w"):
            return (None, Segments((d_inner, d_inner, N, N, H),
                                   (True, True, False, False, True))), "sum"
        if path.endswith(("conv_w", "conv_b")):
            return tuple(None for _ in range(ndim - 1)) + (conv_segments(cfg),), "sum"
        if path.endswith(("A_log", "/D", "dt_bias")):
            return ("model",), "shard"
        if path.endswith("out_proj/w") and lay.d_model:
            return _columns(ndim), "shard"
        return whole                                # the inner norm, out_proj whole
    if "/tmix/" in path:
        m = _RWKV_HEADS.search(path)
        if not lay.ssm_heads or m is None:
            # wo a pair's second product (d_model divides where the heads do)
            split = lay.ssm_heads and path.endswith("tmix/wo/w")
            return (_columns(ndim), "shard") if split else whole
        return _columns(ndim, None if m.group(1) else 0), "shard"
    if "/cmix/" in path:
        split = {"cmix/wk/w": lay.d_ff, "cmix/wv/w": lay.d_ff and lay.d_model,
                 "cmix/wr/w": lay.d_ff and lay.d_model}.get(path[path.find("cmix/"):])
        return (_columns(ndim), "shard") if split else whole
    return None


def _compute_leaf(lay: ModelLayout, cfg, path: str, ndim: int, seq: bool = False):
    """(spec over ``model``, gradient kind) of one leaf (``compute_layout``);
    ``seq``: under sequence parallelism."""
    ssm = _ssm_leaf(lay, cfg, path, ndim)
    if ssm is not None:
        return ssm
    m = _COMPUTE_LEAF.search(path)
    name, wb = (m.group(1), m.group(2)) if m else ("", None)
    # (split over model, applied to this rank's rows of the residual under
    # sequence parallelism): the norms, the router, a whole MLP, the bias added
    # after wd's or (where the heads split) wo's rows
    split, rows = {
        "attn/wq": (lay.heads, False), "attn/wk": (lay.kv_heads, False),
        "attn/wv": (lay.kv_heads, False),
        "attn/wo": (lay.heads and lay.d_model and wb == "w", lay.heads and wb == "b"),
        "mlp/wg": (lay.d_ff, not lay.d_ff), "mlp/wu": (lay.d_ff, not lay.d_ff),
        "mlp/wd": (lay.d_ff and lay.d_model and wb == "w", not lay.d_ff or wb == "b"),
        "moe/wg": (lay.experts != "none", False), "moe/wu": (lay.experts != "none", False),
        "moe/wd": (lay.experts == "ep" or (lay.experts == "tp" and lay.d_model), False),
        "moe/router": (False, True), "attn_norm": (False, True), "mlp_norm": (False, True),
        "final_norm": (False, True), "prologue/norm": (False, True),
        "groups/norm": (False, True), "ln0": (False, True), "ln1": (False, True),
        "ln2": (False, True), "enc_norm": (False, True), "dec_norm": (False, True),
        "emb/table": (lay.vocab, False), "unembed": (lay.vocab, False)}.get(name, (False, False))
    if not split:
        # wk / wv whole under split q heads: each rank uses its q heads' kv heads
        partial = (name in ("attn/wk", "attn/wv") and lay.heads) or (seq and rows)
        return (None,) * ndim, "sum" if partial else "same"
    # experts over EP and the embedding table by rows; the rest by columns
    dim = 0 if (name.startswith("moe/") and lay.experts == "ep") or name == "emb/table" \
        else ndim - 1
    return _columns(ndim, dim), "shard"


def compute_layout(cfg, params_shape, mesh, *, seq: bool = False, stacks=None):
    """For each leaf of ``params_shape``, in leaf order, ``(spec, grad)``: the
    spec over ``model`` alone that the sharded step computes the leaf in (its
    data axes are gathered), from ``model_layout``, and how each model rank's
    gradient of it relates to the leaf's: ``"shard"`` (its block), ``"sum"``
    (a partial sum over the ranks) or ``"same"`` (the whole gradient, alike
    on every rank). ``seq``: under sequence parallelism, where a replicated
    leaf applied to the rank's rows has a ``"sum"`` gradient; ``stacks``
    maps a stack of ``STACK_LEAVES`` to its own answer (``seq`` elsewhere)."""
    lay = model_layout(cfg, axis_sizes(mesh)["model"])
    stacks = stacks or {}
    out = []
    for path_elems, leaf in tree.leaves_with_paths(params_shape):
        path = "/".join(str(p) for p in path_elems if not isinstance(p, int))
        split = next((stacks[k] for k, heads in STACK_LEAVES.items()
                      if k in stacks and path.startswith(heads)), seq)
        out.append(_compute_leaf(lay, cfg, path, len(leaf.shape), split))
    return out


def placements(spec, mesh) -> Tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: each mesh dim is
    ``Shard(i)`` for the tensor dim ``i`` whose entry names it, else
    ``Replicate()``. An entry naming several axes shards its dim over each of
    them; a ``DTensor`` splits a dim over its mesh dims in mesh order, so the
    entry must list them in that order (as ``fsdp_axes`` does)."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} the mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} shards over axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def param_shardings(cfg, params_shape, mesh, **kw):
    """Placements tree matching ``params_shape`` (``placements`` of each
    ``param_specs`` leaf on ``mesh``)."""
    specs = param_specs(cfg, params_shape, mesh, **kw)
    return tree.map_leaves(lambda s: placements(s, mesh), specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------

def batch_spec(mesh) -> Tuple:
    return (fsdp_axes(mesh) if len(fsdp_axes(mesh)) > 1 else fsdp_axes(mesh)[0],)


def data_specs(cfg, shape_kind: str, mesh, *, batch: int):
    """Specs for the input batch dict."""
    dp = fsdp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    b = (dp, None)
    specs = {"tokens": b}
    if shape_kind == "train":
        specs["labels"] = b
    if cfg.family == "vlm":
        specs["embeds"] = (dp, None, None)
    if cfg.family == "encdec":
        specs["frames"] = (dp, None, None)
    return specs


def _kv_spec(cfg, mesh, seq_shard: bool) -> Tuple:
    """``cache_specs``' spec of a ``(L, B, S, Hkv, hd)`` K/V stack."""
    dp = fsdp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    seq_ax, batch_ax = (dpa, None) if seq_shard else (None, dpa)
    if cfg.num_kv_heads % axis_sizes(mesh)["model"] == 0:
        return (None, batch_ax, seq_ax, "model", None)   # (L,B,S,H,D)
    if seq_shard:
        return (None, batch_ax, (dpa, "model") if not isinstance(dpa, tuple)
                else tuple(dpa) + ("model",), None, None)
    return (None, batch_ax, "model", None, None)         # seq over model


def cache_specs(cfg, mesh, *, batch: int, seq_shard: bool = False):
    """Specs for decode caches, in the port's cache tree. seq_shard=True -> SP
    layout for batch=1 long-context: KV sequence over 'data', heads over
    'model'. When KV heads don't divide the TP degree, the cache *sequence*
    shards over 'model' instead.

    The K/V stacks ``(L, B, S, H, D)`` keep the reference's specs; the per-layer
    state lists (ssm ``layers``, hybrid ``prologue`` and ``groups``) hold one
    spec dict a layer, without the reference's stacking dims. ``idx`` is a host
    int here, so it has no spec."""
    kv = _kv_spec(cfg, mesh, seq_shard)
    batch_ax = kv[1]
    if cfg.family in ("dense", "moe", "vlm"):
        return {"k": kv, "v": kv}
    if cfg.family == "ssm":
        return {"layers": [{"S": (batch_ax, "model", None, None),
                            "x_att": (batch_ax, None),
                            "x_cmix": (batch_ax, None)}
                           for _ in range(cfg.num_layers)]}
    if cfg.family == "hybrid":
        def st():
            return {"conv": (batch_ax, None, "model"),
                    "ssm": (batch_ax, "model", None, None)}
        return {"prologue": [st() for _ in range(cfg.hybrid_prologue)],
                "groups": [[st() for _ in range(cfg.hybrid_mamba_per_group)]
                           for _ in range(cfg.hybrid_groups)],
                "attn_k": kv, "attn_v": kv}
    if cfg.family == "encdec":
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv}
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# the serving layout (``serve.decode``'s sharded steps)
# ---------------------------------------------------------------------------

def serve_specs(cfg, params_shape, mesh):
    """The placements the serving steps hold their parameters in, one spec a
    leaf of ``params_shape`` (as ``param_specs`` gives them): each leaf in its
    ``compute_layout`` over ``model`` (residual unsplit) and whole over the
    data axes, so that a step computes on each rank's block with no gather.
    A ``Segments`` entry is ``"model"`` over the leaf's rank-major layout
    (``rank_major``). A serving replica holds its weights; the reference's
    cells place them by ``param_specs`` and its GSPMD step gathers them over
    the data axes at every step."""
    specs = [tuple("model" if isinstance(e, Segments) else e for e in spec)
             for spec, _ in compute_layout(cfg, params_shape, mesh)]
    return tree.rebuild(params_shape, specs, is_leaf=None)


def _segment_map(cfg, params, mesh, to: str):
    tp = axis_sizes(mesh)["model"]
    out = []
    for x, (spec, _) in zip(tree.leaves(params), compute_layout(cfg, params, mesh)):
        for dim, e in enumerate(spec):
            if isinstance(e, Segments):
                x = getattr(e, to)(x, dim, tp)
        out.append(x)
    return tree.rebuild(params, out)


def rank_major(cfg, params, mesh):
    """``params`` (one device's layout: tensors, or meta tensors for shapes)
    as the whole tensors of the serving layout (``serve_specs``): each leaf
    with a ``Segments`` entry rank-major (``Segments.to_rank_major``), the
    others as they are."""
    return _segment_map(cfg, params, mesh, "to_rank_major")


def one_device(cfg, params, mesh):
    """The inverse of ``rank_major``."""
    return _segment_map(cfg, params, mesh, "to_one_device")


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes a spec entry names, in order (none for ``None``)."""
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def entry_block(mesh, entry, size: int) -> Tuple[int, int]:
    """(first, count) of this rank's block of a dim of ``size`` that the spec
    ``entry`` splits: the axes' local ranks in mixed radix, in entry order
    (a ``DTensor`` splits a dim over its mesh dims in mesh order)."""
    sizes, i, n = axis_sizes(mesh), 0, 1
    for a in entry_axes(entry):
        i, n = i * sizes[a] + mesh.get_local_rank(a), n * sizes[a]
    return i * (size // n), size // n


@dataclass(frozen=True)
class CacheBlock:
    """This rank's block of a ``(L, B, S_max, Hkv, hd)`` K/V stack placed by
    ``cache_specs``: ``spec`` the stack's spec after ``sanitize_spec``,
    ``rows`` / ``seq`` / ``heads`` each ``(first, count)`` of the batch, the
    sequence and the kv heads, ``seq_axes`` the axes of more than one rank
    that split the sequence (their blocks' decode partials are merged).
    ``cross`` is an encoder-decoder's second block, of its cross-attention
    cache (``S_max`` the encoder's length). A family without a K/V stack (the
    ssm) has a block of its batch rows alone: ``spec`` splits dim 1 at most."""
    spec: Tuple
    rows: Tuple[int, int]
    seq: Tuple[int, int]
    heads: Tuple[int, int]
    seq_axes: Tuple[str, ...]
    cross: Optional["CacheBlock"] = None

    @property
    def rows_split(self) -> bool:
        """Whether the batch rows are split over the data axes (else every
        rank holds the whole batch)."""
        return self.spec[1] is not None


def _stack_spec(cfg, mesh, shape, seq_shard: bool) -> Tuple:
    """The spec of a ``shape`` K/V stack after ``sanitize_spec``; a family
    without one (the ssm) splits its batch rows alone."""
    kv = _kv_spec(cfg, mesh, seq_shard)
    if cfg.family == "ssm":
        kv = (None, kv[1], None, None, None)
    return sanitize_spec(kv, shape, mesh)


def cache_block(cfg, mesh, *, batch: int, max_seq: int, seq_shard: bool = False,
                s_enc: Optional[int] = None) -> CacheBlock:
    """This rank's ``CacheBlock`` of a cache of ``batch`` rows and ``max_seq``
    positions (``cache_specs``, ``seq_shard`` its long-context layout); an
    encoder-decoder's ``cross`` block holds ``s_enc`` encoder positions
    (``cfg.frontend_len`` by default)."""
    sizes = axis_sizes(mesh)

    def block(length):
        spec = _stack_spec(cfg, mesh, (1, batch, length, cfg.num_kv_heads, cfg.head_dim),
                           seq_shard)
        return CacheBlock(spec=spec, rows=entry_block(mesh, spec[1], batch),
                          seq=entry_block(mesh, spec[2], length),
                          heads=entry_block(mesh, spec[3], cfg.num_kv_heads),
                          seq_axes=tuple(a for a in entry_axes(spec[2]) if sizes[a] > 1))

    out = block(max_seq)
    if cfg.family == "encdec":
        out = replace(out, cross=block(s_enc or cfg.frontend_len))
    return out


def serve_cache_specs(cfg, mesh, *, batch: int, max_seq: int, s_enc: Optional[int] = None,
                      seq_shard: bool = False):
    """The spec of each tensor of a cache of ``batch`` rows and ``max_seq``
    positions (an encoder-decoder's cross cache ``s_enc``, by default
    ``cfg.frontend_len``), in leaf order with ``idx`` left out, as the
    serving steps place it over ``mesh``: the K/V stacks as ``cache_block``
    splits them, a state leaf as ``cache_specs`` says (an RWKV6 ``S`` and a
    Mamba2 ``ssm`` by heads, ``x_att`` / ``x_cmix`` whole over ``model``,
    its rows as the stacks'), where a Mamba2 ``conv`` state, whose channels
    a rank computes on are its ``conv_segments``, splits its rank-major
    layout (``rank_major_cache``; C43). A state's heads split where the
    layout's do (``ModelLayout.ssm_heads``)."""
    def stack(length):
        return _stack_spec(cfg, mesh, (1, batch, length, cfg.num_kv_heads, cfg.head_dim),
                           seq_shard)

    rows = stack(max_seq)[1]
    split = model_layout(cfg, axis_sizes(mesh)["model"]).ssm_heads
    out = []
    for path, spec in tree.leaves_with_paths(cache_specs(cfg, mesh, batch=batch,
                                                         seq_shard=seq_shard), is_leaf=is_spec):
        if path[0] in ("k", "v", "attn_k", "attn_v"):
            spec = stack(max_seq)
        elif path[0] in ("cross_k", "cross_v"):
            spec = stack(s_enc or cfg.frontend_len)
        else:
            spec = (rows,) + tuple(None if e == "model" and not split else e for e in spec[1:])
        out.append(spec)
    return out


def rank_major_cache(cfg, cache, mesh):
    """``cache`` (one device's layout: tensors, or meta tensors for shapes)
    as the whole tensors of the serving layout (``serve_cache_specs``): each
    Mamba2 ``conv`` state rank-major where the heads split
    (``conv_segments``), the rest as it is."""
    tp = axis_sizes(mesh)["model"]
    if cfg.family != "hybrid" or not model_layout(cfg, tp).ssm_heads:
        return cache
    seg = conv_segments(cfg)
    parts = {k: v for k, v in cache.items() if k != "idx"}
    out = tree.rebuild(parts, [seg.to_rank_major(x, x.dim() - 1, tp) if path[-1] == "conv" else x
                               for path, x in tree.leaves_with_paths(parts)])
    out["idx"] = cache["idx"]
    return out
