"""Meta input specs and the steps of every (arch x shape) cell.

This package's port of the JAX package's ``launch/specs.py``.  Where the
reference makes ``ShapeDtypeStruct`` stand-ins, the port makes meta
tensors (shapes and dtypes, no bytes): ``Model.init(device="meta")``,
``train.step.init_state(..., "meta")``, ``init_cache(..., "meta")`` and
``hntl_attention.kv_index_specs``.  ``build_cell`` returns the step the
dry-run traces (``launch.dryrun``) and its inputs:

  train cells   -> (TrainState, {"tokens", "labels", ...})
  prefill cells -> (params, tokens[, positions]) or (params, frames)
  decode cells  -> (params, token, caches, pos), whisper's with its self
                   and cross caches

The port's caches are a list with one entry per layer where the
reference stacks a group dim, and its parameters are unrolled modules:
a spec here is the reference's trailing entries (its stacked leaf's
spec without the leading group ``None``).  ``cell_in_shardings`` places
every input on a mesh with the port's ``ShardingRules`` /
``NamedSharding``: parameters and moments by ``infer_param_specs``, the
batch over the "batch" axes, caches by ``_CACHE_LEAF_RULES``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs import get_config, get_shape
from ..distributed import sharding as shd
from ..models import Model, get_model
from ..models import encdec as encdec_mod
from ..models import hntl_attention as H
from ..models import transformer as T
from ..models.config import ModelConfig
from ..optim.adamw import AdamW, warmup_cosine
from ..train.step import TrainState, init_state, make_train_step

# Whisper: the assigned seq axis is the *encoder memory* (frames); the
# decoder target length is the model's max_target_len (448).
WHISPER_DEC_LEN = 448
VLM_PATCHES = 1024


def make_optimizer(total_steps: int = 10_000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, 200, total_steps))


def long_decode_cfg(cfg: ModelConfig) -> ModelConfig:
    """Full-config retrieval geometry for the 500k cell: grain = 4096
    tokens, tail = one grain, pool 128, nprobe 8."""
    return dataclasses.replace(cfg, kv_cap=4096, kv_tail=4096, kv_kt=16,
                               kv_nprobe=8, kv_pool=128)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Meta stand-ins (no allocation)
# ---------------------------------------------------------------------------


def abstract_params(model: Model):
    return model.init(0, device="meta")


def abstract_state(model: Model, optimizer: AdamW) -> TrainState:
    return init_state(model, optimizer, 0, "meta")


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    if cfg.family == "encdec":
        return {"frames": _meta((batch, seq, cfg.d_model), torch.float32),
                "tokens": _meta((batch, WHISPER_DEC_LEN), torch.int32),
                "labels": _meta((batch, WHISPER_DEC_LEN), torch.int32)}
    b = {"tokens": _meta((batch, seq), torch.int32),
         "labels": _meta((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        b["positions"] = _meta((3, batch, seq), torch.int32)
        b["patch_embeds"] = _meta((batch, VLM_PATCHES, cfg.d_model),
                                  torch.bfloat16)
    return b


def _linear_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> list:
    return T.init_cache(cfg, batch, max_len, device="meta")


def _retrieval_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> list:
    """Caches for long_500k: a ``KVIndex`` on global-attention layers, the
    ring or state cache elsewhere; one entry per layer."""
    sealed = seq - cfg.kv_tail
    if sealed % cfg.kv_cap:
        raise ValueError(f"sealed length {sealed} is not a multiple of "
                         f"kv_cap {cfg.kv_cap}")

    def layer_cache(spec):
        if spec.kind == "attn" and spec.window is None:
            return {"mixer": H.kv_index_specs(cfg, batch, sealed,
                                              cfg.compute_dtype), "ffn": ()}
        return T._layer_cache_init(spec, cfg, batch, seq, cfg.compute_dtype,
                                   "meta")

    return [layer_cache(s) for s in T.layer_specs(cfg)]


# ---------------------------------------------------------------------------
# Step functions per cell kind
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, cfg_transform=None):
    """Returns (step_fn, example inputs (meta), cfg) for one cell.

    step_fn(*inputs) is what the dry-run traces.  cfg_transform: an
    optional ModelConfig -> ModelConfig hook (depth cuts, variants)."""
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    sh = get_shape(shape_name)
    model = get_model(cfg)
    b, s = sh.global_batch, sh.seq_len

    if sh.kind == "train":
        opt = make_optimizer()
        step = make_train_step(model, opt, microbatches=1)
        state = abstract_state(model, opt)
        batch = train_batch_specs(cfg, b, s)
        return step, (state, batch), cfg

    if cfg.family == "encdec":
        return _build_encdec_serve_cell(model, cfg, sh)

    params = abstract_params(model)
    if sh.kind == "prefill":
        def prefill_step(params, tokens, positions=None):
            return model.prefill(params, tokens, positions=positions,
                                 max_len=s)
        tokens = _meta((b, s), torch.int32)
        if cfg.mrope_sections is not None:
            return (prefill_step,
                    (params, tokens, _meta((3, b, s), torch.int32)), cfg)
        return prefill_step, (params, tokens), cfg

    def step_args(caches):
        return (params, _meta((b,), torch.int32), caches,
                _meta((b,), torch.int32))

    if sh.kind == "decode":
        def decode(params, token, caches, pos):
            return model.decode_step(params, token, caches, pos)
        return decode, step_args(_linear_cache_specs(cfg, b, s)), cfg

    if sh.kind == "long_decode":
        if cfg.is_attention_free or cfg.family in ("ssm", "hybrid"):
            # natively sub-quadratic: recurrent state + ring caches; the
            # cache capacity is window-bounded, not seq-bounded.
            max_len = max([sp.window or 0 for sp in cfg.pattern] + [1024])
            def decode(params, token, caches, pos):
                return model.decode_step(params, token, caches, pos)
            return decode, step_args(_linear_cache_specs(cfg, b, max_len)), \
                cfg
        lcfg = long_decode_cfg(cfg)
        lmodel = get_model(lcfg)
        def decode(params, token, caches, pos):
            return lmodel.decode_step(params, token, caches, pos)
        return decode, step_args(_retrieval_cache_specs(lcfg, b, s)), lcfg

    raise ValueError(sh.kind)


def _build_encdec_serve_cell(model: Model, cfg: ModelConfig, sh):
    b, s = sh.global_batch, sh.seq_len
    params = abstract_params(model)
    if sh.kind == "prefill":
        def enc_step(params, frames):
            memory = model.encode(params, frames)
            return encdec_mod.build_cross_cache(params, cfg, memory)
        return enc_step, (params, _meta((b, s, cfg.d_model),
                                        torch.float32)), cfg

    self_c = encdec_mod.init_self_cache(cfg, b, "meta")
    if sh.kind == "decode":
        shape = (b, s, cfg.n_heads, cfg.head_dim)
        cross = [{"k": _meta(shape, cfg.compute_dtype),
                  "v": _meta(shape, cfg.compute_dtype)}
                 for _ in range(cfg.n_layers)]
        def dec_step(params, token, self_cache, cross_cache, pos):
            return encdec_mod.decode_step(params, cfg, token, self_cache,
                                          cross_cache, pos)
        return dec_step, (params, _meta((b,), torch.int32), self_c, cross,
                          _meta((b,), torch.int32)), cfg

    if sh.kind == "long_decode":
        lcfg = long_decode_cfg(cfg)
        # encoder memory fully sealed (it is static): no tail needed, but
        # kv_index_specs carries a (kv_tail) ring kept for uniformity.
        cross = [H.kv_index_specs(lcfg, b, s - lcfg.kv_tail,
                                  lcfg.compute_dtype)
                 for _ in range(cfg.n_layers)]
        def dec_step(params, token, self_cache, cross_idx, pos):
            return encdec_mod.decode_step_retrieval(
                params, lcfg, token, self_cache, cross_idx, pos)
        return dec_step, (params, _meta((b,), torch.int32), self_c, cross,
                          _meta((b,), torch.int32)), lcfg
    raise ValueError(sh.kind)


# ---------------------------------------------------------------------------
# Shardings for the cell inputs
# ---------------------------------------------------------------------------

_CACHE_LEAF_RULES = {
    # name -> ordered logical axes attempted per trailing dims
    "k": ("cache_batch", "cache_seq", "kv_heads_cache", "head_dim_cache"),
    "v": ("cache_batch", "cache_seq", "kv_heads_cache", "head_dim_cache"),
    "centroids": ("cache_batch", "kv_heads_cache", "cache_grains", None),
    "basis": ("cache_batch", "kv_heads_cache", "cache_grains", None, None),
    "coords": ("cache_batch", "kv_heads_cache", "cache_grains", None, None),
    "res": ("cache_batch", "kv_heads_cache", "cache_grains", None),
    "scale": ("cache_batch", "kv_heads_cache", "cache_grains"),
    "res_scale": ("cache_batch", "kv_heads_cache", "cache_grains"),
    "k_raw": ("cache_batch", "cache_seq", "kv_heads_cache", "head_dim_cache"),
    "v_raw": ("cache_batch", "cache_seq", "kv_heads_cache", "head_dim_cache"),
    "tail_k": ("cache_batch", None, "kv_heads_cache", "head_dim_cache"),
    "tail_v": ("cache_batch", None, "kv_heads_cache", "head_dim_cache"),
    "h": ("cache_batch", "rnn"),
    "conv": ("cache_batch", None, "rnn"),
    "s": ("cache_batch", "act_heads", None, None),
    "shift": ("cache_batch", None),
}

_KV_NAMES = ("k", "v", "k_raw", "v_raw", "tail_k", "tail_v")


def cache_rules(rules: shd.ShardingRules, batch: int) -> shd.ShardingRules:
    """Extend activation rules with cache-leaf logical axes.

    batch==1 (long_500k): batch unshardable -> the grain/seq axes take the
    data axis; batch>1: batch takes data, seq/grains replicate.
    """
    data_axes = rules.rules["batch"]
    extra = {
        "cache_batch": data_axes if batch > 1 else None,
        "cache_seq": None if batch > 1 else data_axes,
        "cache_grains": None if batch > 1 else data_axes,
        "kv_heads_cache": ("model",),
        "head_dim_cache": None,   # fallback only (see below)
    }
    return shd.ShardingRules(mesh=rules.mesh, rules={**rules.rules, **extra},
                             grain_axis=rules.grain_axis)


def cache_leaf_spec(name: str, shape, crules: shd.ShardingRules) -> tuple:
    """The spec of one cache leaf called ``name`` (its last key) of
    ``shape``; a leaf no rule names is replicated."""
    axes = _CACHE_LEAF_RULES.get(name)
    if axes is None:
        return (None,) * len(shape)
    if len(axes) < len(shape):          # leading dims
        axes = (None,) * (len(shape) - len(axes)) + tuple(axes)
    axes = axes[:len(shape)]
    spec = list(crules.spec_for_shape(shape, axes))
    # fallback: if kv heads did not shard (indivisible), shard head_dim
    if name in _KV_NAMES and len(spec) >= 4 and spec[-2] is None \
            and shape[-1] % crules.mesh.shape["model"] == 0 \
            and "model" not in [a for a in spec if a]:
        spec[-1] = "model"
    return tuple(spec)


def map_cache(fn, tree):
    """``fn(name, leaf)`` over every leaf of a cache tree (lists and
    dicts, ``KVIndex`` fields: tensors, or shardings), keeping its
    structure; a ``KVIndex``'s None fields stay None."""
    if isinstance(tree, H.KVIndex):
        return dataclasses.replace(tree, **{
            f.name: fn(f.name, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if getattr(tree, f.name) is not None})
    def node(k, v):
        if isinstance(v, (dict, list, tuple, H.KVIndex)):
            return map_cache(fn, v)
        return fn(k, v)

    if isinstance(tree, dict):
        return {k: node(k, v) for k, v in tree.items()}
    return type(tree)(map_cache(fn, v) for v in tree)


def cell_in_shardings(inputs, cfg, rules: shd.ShardingRules, kind: str,
                      batch: int):
    """A tree of ``NamedSharding``s matching build_cell's inputs."""
    mesh = rules.mesh

    def ns(spec):
        return shd.NamedSharding(mesh, tuple(spec), rules)

    crules = cache_rules(rules, batch)
    data_axes = rules.rules["batch"]

    def batch_leaf(name, leaf):
        if name == "positions" and leaf.dim() == 3:
            return ns(rules.spec_for_shape(leaf.shape,
                                           (None, "batch", "seq")))
        ax = ("batch",) + (None,) * (leaf.dim() - 1)
        return ns(rules.spec_for_shape(leaf.shape, ax))

    def params_shardings(tree):
        return shd.infer_param_shardings(tree, rules)

    def cache_shardings(tree):
        return map_cache(lambda name, leaf: ns(cache_leaf_spec(
            name, tuple(leaf.shape), crules)), tree)

    if kind == "train":
        state, batch_specs = inputs
        opt = state.opt_state
        st_sh = TrainState(
            params=params_shardings(state.params),
            opt_state={"m": params_shardings(opt["m"]),
                       "v": params_shardings(opt["v"]),
                       "count": ns(())},
            step=ns(()))
        return st_sh, {k: batch_leaf(k, v) for k, v in batch_specs.items()}

    if kind == "prefill":
        # bare inputs carry no name, so M-RoPE's [3, B, S] positions take
        # the batch rule on dim 0, as in the reference
        return (params_shardings(inputs[0]),) + tuple(
            batch_leaf("", x) for x in inputs[1:])

    # decode / long_decode: (params, token, caches..., pos); scalars per
    # sequence shard on batch.
    out = [params_shardings(inputs[0])]
    size = rules.axis_size(data_axes)
    for x in inputs[1:]:
        if torch.is_tensor(x) and x.dim() <= 1:
            ok = x.dim() == 1 and batch > 1 and x.shape[0] % size == 0
            entry = (data_axes[0] if len(data_axes) == 1 else data_axes) \
                if ok else None
            out.append(ns((entry,) * x.dim()))
        else:
            out.append(cache_shardings(x))
    return tuple(out)
