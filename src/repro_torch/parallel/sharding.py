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

The rules read the axis sizes by name. They take a ``DeviceMesh`` with named
dims, or any object with a dict ``.shape`` and ``.axis_names`` (a stand-in for
a mesh too large to build, as the planning tests use).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Tuple

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
    z, x, B, C, dt)."""
    sizes: Tuple[int, ...]
    split: Tuple[bool, ...]

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


_COMPUTE_LEAF = re.compile(r"(attn/w[qkvo]|mlp/w[gud]|moe/w[gud]|emb/table|unembed)"
                           r"(?:/([wb]))?$")
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
            return tuple(None for _ in range(ndim - 1)) + (
                Segments((d_inner, N, N), (True, False, False)),), "sum"
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


def _compute_leaf(lay: ModelLayout, cfg, path: str, ndim: int):
    """(spec over ``model``, gradient kind) of one leaf (``compute_layout``)."""
    ssm = _ssm_leaf(lay, cfg, path, ndim)
    if ssm is not None:
        return ssm
    m = _COMPUTE_LEAF.search(path)
    name, wb = (m.group(1), m.group(2)) if m else ("", None)
    split = {"attn/wq": lay.heads, "attn/wk": lay.kv_heads, "attn/wv": lay.kv_heads,
             "attn/wo": lay.heads and lay.d_model and wb == "w",
             "mlp/wg": lay.d_ff, "mlp/wu": lay.d_ff,
             "mlp/wd": lay.d_ff and lay.d_model and wb == "w",
             "moe/wg": lay.experts != "none", "moe/wu": lay.experts != "none",
             "moe/wd": lay.experts == "ep" or (lay.experts == "tp" and lay.d_model),
             "emb/table": lay.vocab, "unembed": lay.vocab}.get(name, False)
    if not split:
        # wk / wv whole under split q heads: each rank uses its q heads' kv heads
        partial = name in ("attn/wk", "attn/wv") and lay.heads
        return (None,) * ndim, "sum" if partial else "same"
    # experts over EP and the embedding table by rows; the rest by columns
    dim = 0 if (name.startswith("moe/") and lay.experts == "ep") or name == "emb/table" \
        else ndim - 1
    return _columns(ndim, dim), "shard"


def compute_layout(cfg, params_shape, mesh):
    """For each leaf of ``params_shape``, in leaf order, ``(spec, grad)``: the
    spec over ``model`` alone that the sharded step computes the leaf in (its
    data axes are gathered), from ``model_layout``, and how each model rank's
    gradient of it relates to the leaf's: ``"shard"`` (its block), ``"sum"``
    (a partial sum over the ranks) or ``"same"`` (the whole gradient, alike
    on every rank)."""
    lay = model_layout(cfg, axis_sizes(mesh)["model"])
    out = []
    for path_elems, leaf in tree.leaves_with_paths(params_shape):
        path = "/".join(str(p) for p in path_elems if not isinstance(p, int))
        out.append(_compute_leaf(lay, cfg, path, len(leaf.shape)))
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


def cache_specs(cfg, mesh, *, batch: int, seq_shard: bool = False):
    """Specs for decode caches, in the port's cache tree. seq_shard=True -> SP
    layout for batch=1 long-context: KV sequence over 'data', heads over
    'model'. When KV heads don't divide the TP degree, the cache *sequence*
    shards over 'model' instead.

    The K/V stacks ``(L, B, S, H, D)`` keep the reference's specs; the per-layer
    state lists (ssm ``layers``, hybrid ``prologue`` and ``groups``) hold one
    spec dict a layer, without the reference's stacking dims. ``idx`` is a host
    int here, so it has no spec."""
    dp = fsdp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    seq_ax, batch_ax = (dpa, None) if seq_shard else (None, dpa)
    heads_divisible = cfg.num_kv_heads % axis_sizes(mesh)["model"] == 0
    if heads_divisible:
        kv = (None, batch_ax, seq_ax, "model", None)   # (L,B,S,H,D)
    elif seq_shard:
        kv = (None, batch_ax, (dpa, "model") if not isinstance(dpa, tuple)
              else tuple(dpa) + ("model",), None, None)
    else:
        kv = (None, batch_ax, "model", None, None)     # seq over model
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
