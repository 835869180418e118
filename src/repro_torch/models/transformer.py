"""Decoder-only LM covering the dense / MoE / hybrid / SSM / VLM families.

This package's port of the JAX package's ``models/transformer.py``:
``loss_fn`` (cross-entropy plus ``MOE_AUX_WEIGHT`` times the MoE
load-balance aux, summed over layers), ``forward``, and the serving
entry points ``prefill`` and ``decode_step``.  A layer's token mixer is
attention (full or windowed), the RG-LRU block (``rglru``) or RWKV6's
time-mix (``rwkv6``); its channel mixer is a dense MLP, the mixture of
experts (``ffn.moe_apply``, when ``n_experts``) or, in an RWKV layer,
RWKV6's channel-mix.

The model is an ``nn.Module`` (``Transformer``) whose parameters keep the
reference's names and shapes (``wq`` is [d, Hq, hd] and applied by
``einsum``), so weights carry across as copies
(``interop.params_from_numpy``).  The reference stacks the ``pattern``'s
repeats and runs them under ``lax.scan``; here the stack is unrolled:
``layers[g * len(pattern) + i]`` is the reference's
``params["groups"][f"l{i}"][g]``, and the ``tail`` layers follow.  The
reference's sharding hints (``constrain``) are dropped: on one device
they are no-ops, and on a mesh the training loss of an attention-only
decoder splits where they split, explicitly, over a data row's model
slots (``SlotParams``: each slot its heads, MLP columns and vocab rows,
the partial sums of ``wo`` and ``w_down`` added in float32); with
experts every row steps at once (``mesh_loss``), each slot computing a
block of the experts over a block of the whole batch's capacity.

With ``cfg.remat`` each pattern group of a forward that records gradients
is checkpointed, as the reference's ``jax.checkpoint`` around its scanned
group: ``remat_policy="full"`` keeps only the group's input and recomputes
the rest in the backward pass; ``"dots"`` keeps the matrix products'
outputs and recomputes the rest; ``"none"`` keeps everything.  The
recomputation runs the same ops on the same inputs, so no number changes.
Parameters are made without gradients (serving); ``train.step.init_state``
turns them on, and ``prefill`` / ``decode_step`` record no graph either way.

Caches are a list, one entry per layer in layer order:
``{"mixer": {"k", "v"} | KVIndex, "ffn": ()}`` for attention,
``{"mixer": {"h", "conv"}, "ffn": ()}`` for RG-LRU and
``{"mixer": {"s", "shift"}, "ffn": {"shift"}}`` for RWKV6 (the
channel-mix's token shift).  Windowed layers keep ring caches of
``min(window, max_len)`` slots; recurrent layers keep a fixed-size
state whatever the context.  A decode step returns new
caches and leaves its inputs as they were, as the reference's does.
Entry points run their matrix products at full precision
(``core.index.full_fp32_matmul``: no TF32, bf16 reduced in float32).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..core.index import full_fp32_matmul, resolve_device
from ..kernels import counting
from . import ffn, rglru, rwkv6
from .attention import attention, decode_attention
from .common import (apply_rope, cross_entropy, dense_init, embed,
                     embed_block, embed_init, make_norm, matmul_f32,
                     softcap, token_mean, unembed, vocab_block_terms)
from .config import LayerSpec, ModelConfig

MOE_AUX_WEIGHT = 0.01


def layer_specs(cfg: ModelConfig) -> list:
    """Every layer's spec, in layer order (groups, then the tail)."""
    return list(cfg.pattern) * cfg.n_groups + list(cfg.tail_pattern)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A node of the parameter tree: tensors become parameters (no
    gradient until training turns it on), mappings child nodes.
    ``node["name"]`` reads a child as the reference's dict access does."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules


class Transformer(ParamTree):
    """The model's parameters: ``embedding`` [V, d], ``final_norm``,
    ``layers`` (an ``nn.ModuleList``, unrolled groups then the tail) and,
    untied, ``lm_head`` [V, d]."""

    def __init__(self, cfg: ModelConfig, tree: Mapping, layers):
        super().__init__(tree)
        self.cfg = cfg
        self.layers = nn.ModuleList(ParamTree(lp) for lp in layers)

    @property
    def device(self) -> torch.device:
        return self.embedding.device


def _attn_init(gen, cfg: ModelConfig, dtype):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {"wq": dense_init(gen, (d, hq, hd), 0, dtype),
         "wk": dense_init(gen, (d, hkv, hd), 0, dtype),
         "wv": dense_init(gen, (d, hkv, hd), 0, dtype),
         "wo": dense_init(gen, (hq, hd, d), 0, dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((hd,), dtype=dtype, device=dev)}
        p["k_norm"] = {"scale": torch.zeros((hd,), dtype=dtype, device=dev)}
    return p


def _mixer_init(gen, spec: LayerSpec, cfg: ModelConfig, dtype):
    if spec.kind == "attn":
        return _attn_init(gen, cfg, dtype)
    if spec.kind == "rglru":
        nb = max(1, cfg.rnn_dim // max(cfg.head_dim, 1))
        return rglru.rg_block_init(gen, cfg.d_model, cfg.rnn_dim, nb,
                                   cfg.conv_width, dtype)
    if spec.kind == "rwkv":
        return rwkv6.timemix_init(gen, cfg.d_model, cfg.rwkv_head_size,
                                  dtype)
    raise ValueError(spec.kind)


def _ffn_init(gen, spec: LayerSpec, cfg: ModelConfig, dtype):
    if spec.kind == "rwkv":
        return rwkv6.channelmix_init(gen, cfg.d_model, cfg.d_ff, dtype)
    if cfg.n_experts:
        return ffn.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype)
    return ffn.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype)


def _layer_init(gen, spec: LayerSpec, cfg: ModelConfig, dtype):
    norm_init, _ = make_norm(cfg.norm)
    dev = gen.device
    p = {"pre_norm": norm_init(cfg.d_model, dtype, dev),
         "mixer": _mixer_init(gen, spec, cfg, dtype),
         "mlp_pre_norm": norm_init(cfg.d_model, dtype, dev),
         "ffn": _ffn_init(gen, spec, cfg, dtype)}
    if cfg.post_norm:
        p["post_norm"] = norm_init(cfg.d_model, dtype, dev)
        p["mlp_post_norm"] = norm_init(cfg.d_model, dtype, dev)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """A new model on the generator's device, its weights drawn in layer
    order, then the embedding, then (untied) ``lm_head``.

    The reference draws ``lm_head`` from the embedding's key, so its
    untied models start with ``lm_head == embedding``; here ``lm_head``
    takes its own draw (ROADMAP, faults of the reference)."""
    dtype = cfg.compute_dtype
    norm_init, _ = make_norm(cfg.norm)
    layers = [_layer_init(gen, spec, cfg, dtype)
              for spec in layer_specs(cfg)]
    tree = {"embedding": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
            "final_norm": norm_init(cfg.d_model, dtype, gen.device)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = embed_init(gen, (cfg.vocab, cfg.d_model), dtype)
    return Transformer(cfg, tree, layers)


# ---------------------------------------------------------------------------
# Layer apply (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------


def _qk_rmsnorm(p, x, eps):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = _qk_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = _qk_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    rd = int(cfg.head_dim * cfg.rotary_pct)
    q = apply_rope(q, positions, cfg.rope_theta, rd, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, rd, cfg.mrope_sections)
    return q, k, v


def _attn_apply(p, x, cfg: ModelConfig, spec: LayerSpec, positions,
                partial: bool = False):
    """Full-segment attention (forward / prefill).  x [B, S, d].
    ``partial``: ``p`` holds one model slot's heads, and the output is
    its float32 partial sum of ``wo``'s product (``SlotParams.run``)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attention(q, k, v, causal=True, window=spec.window,
                    logit_cap=cfg.attn_logit_cap, scale=cfg.attn_scale,
                    p_bf16=cfg.attn_p_bf16)
    if partial:
        wo = p["wo"]
        return matmul_f32(out.flatten(2), wo.reshape(-1, wo.shape[-1])), \
            (k, v)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def _mixer_apply(p, x, cfg, spec, positions, state):
    """Returns (y, kv_for_cache_or_None, new_state)."""
    if spec.kind == "attn":
        if state is not None and x.shape[1] == 1:       # decode step
            from .hntl_attention import KVIndex
            if isinstance(state, KVIndex):              # HNTL-KV retrieval
                y, new_state = _attn_retrieval_decode(p, x, cfg, spec,
                                                      positions, state)
            else:
                y, new_state = _attn_decode(p, x, cfg, spec, positions,
                                            state)
            return y, None, new_state
        y, kv = _attn_apply(p, x, cfg, spec, positions)
        return y, kv, state
    if spec.kind == "rglru":
        y, new_state = rglru.rg_block_apply(p, x, state)
        return y, None, new_state
    if spec.kind == "rwkv":
        y, new_state = rwkv6.timemix_apply(p, x, cfg.rwkv_head_size, state)
        return y, None, new_state
    raise ValueError(spec.kind)


def _ffn_apply(p, x, cfg: ModelConfig, spec: LayerSpec, state):
    """Returns (y, aux, new_state)."""
    if spec.kind == "rwkv":
        y, new_state = rwkv6.channelmix_apply(p, x, state)
        return y, 0.0, new_state
    if cfg.n_experts:
        y, aux = ffn.moe_apply(p, x, top_k=cfg.moe_top_k,
                               capacity_factor=cfg.capacity_factor,
                               norm_topk=cfg.norm_topk)
        return y, aux, state
    return ffn.mlp_apply(p, x, cfg.mlp_kind), 0.0, state


def _layer_apply(p, x, cfg: ModelConfig, spec: LayerSpec, positions,
                 state=None):
    """One (mixer + channel-mix) layer.  Returns (x, aux, kv, new_state):
    aux is the MoE load-balance loss (0.0 without experts)."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["pre_norm"], x, cfg.norm_eps)
    mixer_state = state["mixer"] if state is not None else None
    y, kv, new_mixer_state = _mixer_apply(p["mixer"], h, cfg, spec,
                                          positions, mixer_state)
    if cfg.post_norm:
        y = norm(p["post_norm"], y, cfg.norm_eps)
    x = x + y
    h = norm(p["mlp_pre_norm"], x, cfg.norm_eps)
    ffn_state = state["ffn"] if state is not None else None
    y, aux, new_ffn_state = _ffn_apply(p["ffn"], h, cfg, spec, ffn_state)
    if cfg.post_norm:
        y = norm(p["mlp_post_norm"], y, cfg.norm_eps)
    x = x + y
    new_state = None
    if state is not None:
        new_state = {"mixer": new_mixer_state, "ffn": new_ffn_state}
    return x, aux, kv, new_state


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _tokens(params: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).long()


def _embed_tokens(params, cfg: ModelConfig, tokens, patch_embeds=None):
    x = embed(params["embedding"], tokens, scale_by_dim=cfg.embed_scale)
    return _with_patches(x, patch_embeds)


def _with_patches(x, patch_embeds):
    if patch_embeds is not None:                       # VLM stub frontend
        pe = torch.as_tensor(patch_embeds, device=x.device).to(x.dtype)
        # dynamic_update_slice at (0, 1, 0): the start clamps to fit
        start = max(0, min(1, x.shape[1] - pe.shape[1]))
        x = x.clone()
        x[:, start:start + pe.shape[1]] = pe
    return x


def _default_positions(cfg: ModelConfig, batch, seq, offset=0,
                       device=None):
    pos = offset + torch.arange(seq, device=device)
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos.expand(3, batch, seq)                # text-only: all equal
    return pos


def _positions(params, cfg, positions, b, s):
    if positions is None:
        return _default_positions(cfg, b, s, device=params.device)
    return torch.as_tensor(positions, device=params.device).long()


def _final_hidden(params, cfg, x):
    _, norm = make_norm(cfg.norm)
    return norm(params["final_norm"], x, cfg.norm_eps)


#: The ops whose outputs ``remat_policy="dots"`` keeps: the matrix
#: products (``einsum`` and ``@`` reach these).
_PRODUCT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _keep_products(ctx, op, *args, **kwargs):
    if op in _PRODUCT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, checkpointed by ``cfg.remat`` / ``cfg.remat_policy``
    when autograd records (a forward under ``torch.no_grad`` keeps
    nothing anyway)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "none":
        return fn(*args)
    if cfg.remat_policy == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _keep_products))
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full, "
                     "dots or none)")


def _group_apply(layers, specs, cfg, positions, x, aux):
    """One pattern group's layers; the aux summed on in layer order."""
    for lp, spec in zip(layers, specs):
        x, a, _, _ = _layer_apply(lp, x, cfg, spec, positions)
        aux = aux + a
    return x, aux


def forward(params: Transformer, cfg: ModelConfig, tokens, positions=None,
            patch_embeds=None):
    """Full-segment forward.  Returns (hidden [B, S, d], aux): the MoE
    load-balance aux summed over layers in layer order (0.0 without
    experts)."""
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    positions = _positions(params, cfg, positions, b, s)
    specs, n = layer_specs(cfg), len(cfg.pattern)
    aux = 0.0
    with full_fp32_matmul():
        x = _embed_tokens(params, cfg, tokens, patch_embeds)
        for g in range(cfg.n_groups):
            part = slice(g * n, (g + 1) * n)
            x, aux = remat(cfg, _group_apply, params.layers[part],
                           specs[part], cfg, positions, x, aux)
        for i in range(cfg.n_groups * n, len(specs)):       # the tail
            x, a, _, _ = _layer_apply(params.layers[i], x, cfg, specs[i],
                                      positions)
            aux = aux + a
        return _final_hidden(params, cfg, x), aux


def logits_fn(params, cfg: ModelConfig, hidden):
    table = params["lm_head"] if "lm_head" in params \
        else params["embedding"]
    with full_fp32_matmul():
        return softcap(unembed(table, hidden), cfg.final_logit_cap)


def loss_fn(params: Transformer, cfg: ModelConfig, batch):
    """batch: {"tokens" [B, S], "labels" [B, S] (-100 = pad), optional
    "positions", "patch_embeds"}.  Returns (loss, {"ce", "aux"}): loss is
    the masked token-mean cross-entropy, plus ``MOE_AUX_WEIGHT * aux``
    with experts.  ``params`` may be a ``SlotParams``: one data row's
    parameters split over its model slots."""
    if isinstance(params, SlotParams):
        return _slot_loss(params, cfg, batch)
    hidden, aux = forward(params, cfg, batch["tokens"],
                          batch.get("positions"), batch.get("patch_embeds"))
    logits = logits_fn(params, cfg, hidden)
    labels = _tokens(params, batch["labels"])
    ce = cross_entropy(logits, torch.clamp(labels, min=0), labels >= 0)
    total = ce + MOE_AUX_WEIGHT * aux if cfg.n_experts else ce
    return total, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Tensor parallelism: one data row's step over its model slots
# ---------------------------------------------------------------------------

#: The dim the model axis splits, by a leaf's last name: q heads, kv
#: heads, MLP columns, vocab rows, experts (the router's expert columns)
#: (``distributed.sharding._PARAM_AXES``).
SPLIT_DIMS = {"wq": 1, "bq": 0, "wo": 0, "wk": 1, "wv": 1, "bk": 0, "bv": 0,
              "w_gate": 1, "w_up": 1, "w_down": 0, "embedding": 0,
              "lm_head": 0, "e_gate": 0, "e_up": 0, "e_down": 0,
              "router": 1}
_GROUP = {"wq": "heads", "bq": "heads", "wo": "heads", "wk": "kv",
          "wv": "kv", "bk": "kv", "bv": "kv", "w_gate": "mlp", "w_up": "mlp",
          "w_down": "mlp", "embedding": "vocab", "lm_head": "vocab",
          "e_gate": "experts", "e_up": "experts", "e_down": "experts",
          "router": "experts"}


def splits_over_model(cfg: ModelConfig) -> bool:
    """Whether a train step of ``cfg`` splits its compute over the model
    axis: the attention-only decoders (no recurrent layer, not the
    encoder-decoder), dense or with experts (``splits_experts``)."""
    return (cfg.family != "encdec"
            and all(spec.kind == "attn" for spec in layer_specs(cfg)))


def splits_experts(cfg: ModelConfig) -> bool:
    """Whether that split is expert-parallel: a decoder of
    ``splits_over_model`` with experts, whose rows step in lock step
    (``mesh_loss``: routing and capacity are the whole batch's)."""
    return bool(cfg.n_experts) and splits_over_model(cfg)


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Which products a row's ``n_slots`` model slots split: q heads
    (with ``wo``), kv heads, MLP columns, vocab rows, experts (with the
    router's columns).  A group that is not split is computed once, on
    slot 0.  kv heads not split under split q heads: each slot takes the
    kv heads its q heads read."""

    n_slots: int
    heads: bool
    kv: bool
    mlp: bool
    vocab: bool
    experts: bool = False

    def slots(self, group: str) -> range:
        return range(self.n_slots if getattr(self, group) else 1)


def slot_plan(cfg: ModelConfig, n_slots: int, split_dims) -> SlotPlan:
    """The plan of ``cfg``'s step over ``n_slots`` model slots, from
    ``split_dims``: {leaf name: the dim its spec splits over the model
    axis, or None}.  A leaf split where the step cannot split it raises:
    nothing is gathered whole in its place."""
    if not splits_over_model(cfg):
        raise ValueError(f"{cfg.name}'s step does not split over the "
                         "model axis")
    if cfg.n_experts and cfg.n_experts % n_slots:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{n_slots} model slots")
    seen: dict = {}
    for name, dim in split_dims.items():
        last = name.rsplit(".", 1)[-1]
        want = SPLIT_DIMS.get(last)
        if dim is not None and dim != want:
            raise ValueError(
                f"{name} is split over the model axis on dim {dim}; the "
                "step " + (f"splits it on dim {want}"
                                           if want is not None
                                           else "keeps it whole"))
        if want is not None:
            seen.setdefault(_GROUP[last], set()).add(dim is not None)
    for group, split in seen.items():
        if len(split) > 1:
            raise ValueError(f"only some {group} leaves are split over "
                             "the model axis")
    flags = {g: True in seen.get(g, ()) for g in ("heads", "kv", "mlp",
                                                   "vocab", "experts")}
    if flags["kv"] and not flags["heads"]:
        raise ValueError("kv heads split over the model axis, q heads not")
    if flags["heads"] and not flags["kv"]:
        hq, g = cfg.n_heads // n_slots, cfg.n_heads // cfg.n_kv_heads
        if hq % g and g % hq:
            raise ValueError(
                f"{hq} q heads per slot do not align with groups of {g} "
                "q heads per kv head")
    return SlotPlan(n_slots=n_slots, **flags)


def slot_slices(plan: SlotPlan, cfg: ModelConfig, name: str, shape,
                m: int) -> Optional[tuple]:
    """The part of leaf ``name`` (slices per dim) model slot ``m``
    computes with, or None where slot m does not use it: block m of a
    split group, the kv heads slot m's q heads read, the q / k norm
    scales on every attention slot, the other norms whole on every slot
    (the residual stream's, which every device of a row keeps), a group
    that is not split whole on slot 0."""
    part = [slice(0, n) for n in shape]
    last = name.rsplit(".", 1)[-1]
    group = _GROUP.get(last)
    if group is None:
        if ".q_norm." in name or ".k_norm." in name:
            return tuple(part) if m in plan.slots("heads") else None
        return tuple(part)
    dim = SPLIT_DIMS[last]
    if getattr(plan, group):
        k = shape[dim] // plan.n_slots
        part[dim] = slice(m * k, (m + 1) * k)
        return tuple(part)
    if group == "kv" and plan.heads:
        hq, g = cfg.n_heads // plan.n_slots, cfg.n_heads // cfg.n_kv_heads
        part[dim] = slice(m * hq // g, ((m + 1) * hq - 1) // g + 1)
        return tuple(part)
    return tuple(part) if m == 0 else None


class _SlotTree:
    """Read access to one slot's {dotted name: tensor} as a parameter
    tree: ``node["mixer"]["wq"]``, ``"lm_head" in node``."""

    def __init__(self, flat: dict, prefix: str = ""):
        self.flat, self.prefix = flat, prefix

    def __getitem__(self, name):
        key = self.prefix + name
        if key in self.flat:
            return self.flat[key]
        return _SlotTree(self.flat, key + ".")

    def __contains__(self, name) -> bool:
        key = self.prefix + name
        return key in self.flat or any(k.startswith(key + ".")
                                       for k in self.flat)


def _shares(n: int, parts: int) -> list:
    """``n`` split into ``parts`` contiguous shares, the first ``n %
    parts`` one longer (``SlotParams.all_reduce``'s split)."""
    return [n // parts + (p < n % parts) for p in range(parts)]


class _SlotMove(torch.autograd.Function):
    """A tensor moved from slot ``src`` to slot ``dst`` (on ``device``),
    its gradient moved back; the bytes both ways reported to the cost
    counter as ``kind`` (``counting.report_move``)."""

    @staticmethod
    def forward(ctx, src, dst, device, kind, x):
        ctx.src, ctx.dst, ctx.device, ctx.kind = src, dst, x.device, kind
        counting.report_move(src, dst, x.numel() * x.element_size(), kind)
        return x.view_as(x) if x.device == device else x.to(device)

    @staticmethod
    def backward(ctx, g):
        counting.report_move(ctx.dst, ctx.src, g.numel() * g.element_size(),
                             ctx.kind)
        return None, None, None, None, \
            g.view_as(g) if g.device == ctx.device else g.to(ctx.device)


def _move_between(x, src: "SlotParams", m: int, dst: "SlotParams", n: int):
    """``x`` from slot m of one data row to slot n of another: an
    "all_to_all" move between the rows' slots (mesh numbering)."""
    return _SlotMove.apply(src.base + m, dst.base + n, dst.devices[n],
                           "all_to_all", x)


class SlotParams:
    """One data row's parameters over its ``plan.n_slots`` model slots:
    ``flat[m]`` holds slot m's part of each leaf it uses
    (``slot_slices``) on ``devices[m]``; ``base`` is the mesh number of
    its slot 0 (row j's is j * model), under which the cost counter sees
    its slots.  ``loss_fn`` of a ``SlotParams`` is the row's loss
    computed as the reference's SPMD step splits it:

    - the residual stream, the norms and their scales whole on every
      place of the row: each distinct device (each slot, under a cost
      counter, as on a mesh of one device per slot) keeps the stream and
      computes the norms once for its slots;
    - each slot its heads (RoPE, attention and ``wo``), MLP columns and
      vocab rows; the float32 partial sums of ``wo`` and ``w_down``
      all-reduced over the places (each place sums its share of the
      tokens in slot order and rounds it once to the activation dtype,
      then every place gathers the shares), so each sum is the one a
      single device adds;
    - the embedding's vocab blocks all-reduced the same way (exact: one
      non-zero term per token); the cross-entropy from each block's
      logsumexp and target logit, combined on slot 0, the logits never
      gathered;
    - a group the plan does not split runs once, on slot 0, and its
      result goes to every place.

    A config with experts steps every row at once (``mesh_loss``)."""

    def __init__(self, cfg: ModelConfig, plan: SlotPlan, devices,
                 flat: list, base: int = 0):
        self.cfg, self.plan, self.flat, self.base = cfg, plan, flat, base
        self.devices = tuple(torch.device(d) for d in devices)
        places: dict = {}
        for m, d in enumerate(self.devices):
            places.setdefault(m if counting.active() else d, []).append(m)
        #: the first slot of each place; ``place[m]``: slot m's place
        self.owners = [ms[0] for ms in places.values()]
        self.place = [0] * len(self.devices)
        for p, ms in enumerate(places.values()):
            for m in ms:
                self.place[m] = p

    def tree(self, m: int, prefix: str = "") -> _SlotTree:
        return _SlotTree(self.flat[m], prefix)

    def slot(self, m: int):
        """The cost counter's block for slot m's work."""
        return counting.slot(self.base + m)

    def move(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        return _SlotMove.apply(self.base + src, self.base + dst,
                               self.devices[dst], "model_sum", x)

    def each_place(self, fn, *streams) -> list:
        """[``fn(owner slot, *the streams' tensors there)``] per place."""
        out = []
        for p, m in enumerate(self.owners):
            with self.slot(m):
                out.append(fn(m, *(s[p] for s in streams)))
        return out

    def all_reduce(self, parts: list, slots, dtype) -> list:
        """The sum of ``parts`` (one per slot of ``slots``, on its device)
        on every place, added in slot order and rounded once to
        ``dtype``: each place sums one share of the tokens (dim 1)."""
        n = len(self.owners)
        if n == 1:
            with self.slot(0):
                total = parts[0]
                for x in parts[1:]:
                    total = total + x
                return [total.to(dtype)]
        shares = [torch.split(x, _shares(parts[0].shape[1], n), dim=1)
                  for x in parts]
        summed = []
        for p, o in enumerate(self.owners):
            with self.slot(o):
                total = None
                for m, sh in zip(slots, shares):
                    x = self.move(sh[p], m, o)
                    total = x if total is None else total + x
                summed.append(total.to(dtype))
        return self.each_place(lambda o: torch.cat(
            [self.move(x, q, o) for q, x in zip(self.owners, summed)],
            dim=1))

    def broadcast(self, x: torch.Tensor) -> list:
        """``x``, on slot 0, on every place."""
        return self.each_place(lambda o: self.move(x, 0, o))

    def run(self, group: str, xs: list, fn, dtype) -> list:
        """``fn(m, x)`` on each slot of ``group`` with its place's stream
        ``x``, all-reduced (a group the plan splits: float32 partial
        sums) or sent from slot 0 to every place (a group it does not)."""
        slots, out = self.plan.slots(group), []
        for m in slots:
            with self.slot(m):
                out.append(fn(m, xs[self.place[m]]))
        if getattr(self.plan, group):
            return self.all_reduce(out, slots, dtype)
        return self.broadcast(out[0])

    def normed(self, prefix: str, key: str, streams: list) -> list:
        """Norm ``prefix + key`` of the stream on each place."""
        _, norm = make_norm(self.cfg.norm)
        return self.each_place(lambda o, x: norm(
            self.tree(o, prefix)[key], x, self.cfg.norm_eps), streams)

    def add(self, streams: list, ys: list) -> list:
        return self.each_place(lambda o, x, y: x + y, streams, ys)


def _slot_mixer_half(sp: SlotParams, i: int, xs, cfg, spec, positions):
    """Layer ``i``'s attention over the row's slots, added to the
    residual stream ``xs`` (one per place)."""
    pre = f"layers.{i}."
    ys = sp.run("heads", sp.normed(pre, "pre_norm", xs),
                lambda m, h: _attn_apply(
                    sp.tree(m, pre + "mixer."), h, cfg, spec, positions[m],
                    partial=sp.plan.heads)[0], xs[0].dtype)
    if cfg.post_norm:
        ys = sp.normed(pre, "post_norm", ys)
    return sp.add(xs, ys)


def _slot_layer_apply(sp: SlotParams, i: int, xs, cfg, spec, positions):
    """Layer ``i`` over the row's slots (``_layer_apply``'s training
    forward); ``xs``: the residual stream on each place."""
    pre = f"layers.{i}."
    xs = _slot_mixer_half(sp, i, xs, cfg, spec, positions)
    ys = sp.run("mlp", sp.normed(pre, "mlp_pre_norm", xs),
                lambda m, h: ffn.mlp_apply(sp.tree(m, pre + "ffn."), h,
                                           cfg.mlp_kind,
                                           partial=sp.plan.mlp),
                xs[0].dtype)
    if cfg.post_norm:
        ys = sp.normed(pre, "mlp_post_norm", ys)
    return sp.add(xs, ys)


def _slot_group_apply(sp, layers, specs, cfg, positions, *xs):
    xs = list(xs)
    for i, spec in zip(layers, specs):
        xs = _slot_layer_apply(sp, i, xs, cfg, spec, positions)
    return tuple(xs)


def _slot_inputs(sp: SlotParams, cfg: ModelConfig, batch) -> dict:
    """One row's batch on its slot 0: tokens, labels, positions on every
    slot's device, the patch embeddings."""
    home = sp.devices[0]
    tokens = torch.as_tensor(batch["tokens"], device=home).long()
    b, s = tokens.shape
    pos = batch.get("positions")
    pos = _default_positions(cfg, b, s, device=home) if pos is None \
        else torch.as_tensor(pos, device=home).long()
    return {"tokens": tokens, "positions": [pos.to(d) for d in sp.devices],
            "labels": torch.as_tensor(batch["labels"], device=home).long(),
            "patches": batch.get("patch_embeds")}


def _slot_embed(sp: SlotParams, cfg: ModelConfig, inp: dict) -> list:
    """The embedded tokens (patches written in) on each place."""
    tokens = inp["tokens"]

    def embed_slot(m, _):
        table, tok = sp.tree(m)["embedding"], tokens.to(sp.devices[m])
        if not sp.plan.vocab:
            return embed(table, tok, cfg.embed_scale)
        return embed_block(table, tok, m * table.shape[0], cfg.embed_scale)

    xs = sp.run("vocab", [None] * len(sp.owners), embed_slot,
                cfg.compute_dtype)
    return sp.each_place(lambda o, x: _with_patches(x, inp["patches"]), xs)


def _slot_ce(sp: SlotParams, cfg: ModelConfig, xs: list, labels):
    """The row's masked token-mean cross-entropy, on slot 0, from each
    vocab block's logsumexp and target logit."""
    target = torch.clamp(labels, min=0)

    def terms(m, h):
        p = sp.tree(m)
        table = p["lm_head"] if "lm_head" in p else p["embedding"]
        logits = softcap(unembed(table, h), cfg.final_logit_cap)
        return vocab_block_terms(logits, target.to(sp.devices[m]),
                                 m * table.shape[0])

    reads = {sp.place[m] for m in sp.plan.slots("vocab")}
    hidden = sp.each_place(lambda o, x: _final_hidden(sp.tree(o), cfg, x)
                           if sp.place[o] in reads else None, xs)
    lses, lls = [], []
    for m in sp.plan.slots("vocab"):
        with sp.slot(m):
            lse, ll = terms(m, hidden[sp.place[m]])
        lses.append(sp.move(lse, m, 0))
        lls.append(sp.move(ll, m, 0))
    with sp.slot(0):
        lse = lses[0] if len(lses) == 1 \
            else torch.logsumexp(torch.stack(lses), dim=0)
        ll = lls[0]
        for x in lls[1:]:
            ll = ll + x             # exact: one non-zero term per token
        return token_mean(lse - ll, labels >= 0)


def _slot_loss(sp: SlotParams, cfg: ModelConfig, batch):
    """``loss_fn`` of one data row over its model slots (``SlotParams``)."""
    inp = _slot_inputs(sp, cfg, batch)
    positions = inp["positions"]
    specs, n = layer_specs(cfg), len(cfg.pattern)
    with full_fp32_matmul():
        xs = _slot_embed(sp, cfg, inp)
        for g in range(cfg.n_groups):
            xs = remat(cfg, _slot_group_apply, sp,
                       range(g * n, (g + 1) * n), specs[g * n:(g + 1) * n],
                       cfg, positions, *xs)
        tail = range(cfg.n_groups * n, len(specs))
        xs = _slot_group_apply(sp, tail, [specs[i] for i in tail], cfg,
                               positions, *xs)
        ce = _slot_ce(sp, cfg, xs, inp["labels"])
    return ce, {"ce": ce, "aux": 0.0}


# ---------------------------------------------------------------------------
# Expert parallelism: every data row's step at once
# ---------------------------------------------------------------------------


def _host_counts(counts: list, unit_tokens: list, top_k: int,
                 n_experts: int):
    """The units' [E] pairs per expert as host integers [units, E]; on
    the meta device (a trace, no values) the even split
    (``ffn.even_counts``)."""
    if counts[0].is_meta:
        return ffn.even_counts(unit_tokens, top_k, n_experts)
    return np.stack([c.cpu().numpy() for c in counts])


def _mesh_moe(sps: list, i: int, hs: list, cfg: ModelConfig):
    """The MoE of layer ``i`` over every data row (``hs[j]``: row j's
    normed stream on each of its places), as ``ffn.moe_apply`` computes
    it on the whole batch.  Returns (each row's output on each of its
    places, the layer's aux on row 0's slot 0).

    - A unit is one place of a row with a contiguous share of the row's
      tokens; the units, row by row, hold the batch's tokens in order.
      Each row's experts slots compute their block of the router's
      logits and send each unit its share's rows; the unit routes its
      tokens (softmax, stable top-k) and ranks its pairs within their
      experts.
    - The units' [E] counts cross rows (host integers: they size the
      moves); an exclusive scan gives each unit its ``prior``, so its
      pairs' global ranks are the one-device ranks, and the capacity is
      the whole batch's.
    - Owner (j, m) (row j's slot m) computes experts block m of capacity
      block j (``ffn.cell_owners``): each unit sends each owner its
      pairs' token vectors and cells, the owner fills its [E / M, C_j,
      d] slab, runs ``ffn.expert_ffn`` once and sends each unit its
      pairs' outputs (the all-to-all); every cell of the one-device slab
      is computed once on the mesh.
    - Each unit combines its tokens' K outputs (``ffn.combine``) and
      every place of the row gathers the shares; the aux is the Switch
      loss of the whole batch, from the units' sums of the router's
      probabilities and top-1 counts, on row 0's slot 0."""
    pre = f"layers.{i}.ffn."
    plan = sps[0].plan
    n_exp, top_k = cfg.n_experts, cfg.moe_top_k
    experts = list(plan.slots("experts"))
    n_rows, n_blocks = len(sps), len(experts)
    units = []
    for j, (sp, h) in enumerate(zip(sps, hs)):
        d = h[0].shape[-1]
        sizes = _shares(h[0].shape[0] * h[0].shape[1], len(sp.owners))
        logits = []
        for m in experts:
            with sp.slot(m):
                x = h[sp.place[m]]
                logits.append(torch.split(
                    x.reshape(-1, d).to(torch.float32)
                    @ sp.tree(m, pre)["router"], sizes))
        for p, o in enumerate(sp.owners):
            parts = [sp.move(lg[p], m, o) for m, lg in zip(experts, logits)]
            with sp.slot(o):
                lg = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
                probs, top_p, top_e = ffn.route(lg, top_k, cfg.norm_topk)
                flat_e, rank, counts = ffn.expert_ranks(top_e, n_exp)
                psum = torch.sum(probs, dim=0)
                top1 = torch.sum(torch.nn.functional.one_hot(
                    top_e[:, 0], n_exp).to(torch.float32), dim=0)
                x = torch.split(h[p].reshape(-1, d), sizes)[p]
            units.append(dict(row=j, slot=o, x=x, top_p=top_p,
                              flat_e=flat_e, rank=rank, counts=counts,
                              psum=psum, top1=top1))
    unit_tokens = [u["x"].shape[0] for u in units]
    n_tok = sum(unit_tokens)
    cap = ffn._capacity(n_tok, n_exp, top_k, cfg.capacity_factor)
    counts = _host_counts([u["counts"] for u in units], unit_tokens, top_k,
                          n_exp)
    prior = np.cumsum(counts, 0) - counts
    # [units, capacity blocks, experts blocks]
    sizes = ffn.owner_sizes(counts, cap, n_rows, n_blocks)
    blocks = ffn.capacity_blocks(cap, n_rows)
    home, psum, top1 = sps[0], None, None
    for u in units:
        sp = sps[u["row"]]
        if u is not units[0]:
            # the scan: the unit's counts to row 0, its prior back
            counting.report_move(sp.base + u["slot"], home.base,
                                 n_exp * 8, "all_to_all")
            counting.report_move(home.base, sp.base + u["slot"],
                                 n_exp * 8, "all_to_all")
        ps = _move_between(u["psum"], sp, u["slot"], home, 0)
        t1 = _move_between(u["top1"], sp, u["slot"], home, 0)
        with home.slot(0):
            psum = ps if psum is None else psum + ps
            top1 = t1 if top1 is None else top1 + t1
    with home.slot(0):
        aux = torch.sum((psum / n_tok) * (top1 / n_tok)) * n_exp

    # dispatch: each unit's pairs to their owners
    inbox: dict = {}            # owner -> [(unit, token vectors, cells)]
    for k, u in enumerate(units):
        sp, o = sps[u["row"]], u["slot"]
        with sp.slot(o):
            pri = torch.as_tensor(prior[k], device=sp.devices[o])
            grank, in_cap = ffn.global_ranks(u["rank"], u["flat_e"], pri,
                                             cap)
            owner, e_loc, c_loc = ffn.cell_owners(
                u["flat_e"], grank, in_cap, cap, n_rows, n_exp, n_blocks)
            want = sizes[k].reshape(-1).tolist()
            pairs = ffn.owner_pairs(owner, want)
        u.update(in_cap=in_cap, pairs=pairs, want=want)
        for w, ix in enumerate(pairs):
            if not want[w]:
                continue
            jj, m = divmod(w, n_blocks)
            with sp.slot(o):
                rows_x = u["x"][torch.div(ix, top_k, rounding_mode="floor")]
                cells = torch.stack([e_loc[ix], c_loc[ix]])
            inbox.setdefault(w, []).append((
                k, _move_between(rows_x, sp, o, sps[jj], experts[m]),
                _move_between(cells, sp, o, sps[jj], experts[m])))

    # each owner's block of the slab, computed once; the outputs sent back
    outbox: dict = {}           # (unit, owner) -> outputs of its pairs
    for w in range(n_rows * n_blocks):
        jj, m = divmod(w, n_blocks)
        sp, slot = sps[jj], experts[m]
        got = inbox.get(w, [])
        p = sp.tree(slot, pre)
        with sp.slot(slot):
            x = hs[jj][0]
            slab = torch.zeros((n_exp // n_blocks, blocks[jj][1],
                                x.shape[-1]), dtype=x.dtype,
                               device=sp.devices[slot])
            if got:
                cells = torch.cat([c for _, _, c in got], dim=1)
                slab = slab.index_put((cells[0], cells[1]),
                                      torch.cat([v for _, v, _ in got]))
            ye = ffn.expert_ffn(p["e_gate"], p["e_up"], p["e_down"], slab)
            outs = torch.split(ye[cells[0], cells[1]],
                               [v.shape[0] for _, v, _ in got]) \
                if got else ()
        for (k, _, _), y in zip(got, outs):
            u = units[k]
            outbox[(k, w)] = _move_between(y, sp, slot, sps[u["row"]],
                                           u["slot"])

    # combine on each unit, then every place of the row gathers the shares
    shares = [[] for _ in sps]
    for k, u in enumerate(units):
        sp, x = sps[u["row"]], u["x"]
        with sp.slot(u["slot"]):
            sent = [w for w, n in enumerate(u["want"]) if n]
            yk = torch.zeros((u["flat_e"].shape[0], x.shape[-1]),
                             dtype=x.dtype, device=x.device)
            if sent:
                yk = yk.index_put(
                    (torch.cat([u["pairs"][w] for w in sent]),),
                    torch.cat([outbox[(k, w)] for w in sent]))
            y = ffn.combine(yk, u["top_p"].reshape(-1), u["in_cap"], top_k)
            shares[u["row"]].append((u["slot"], y.to(x.dtype)))
    ys = []
    for sp, h, parts in zip(sps, hs, shares):
        ys.append(sp.each_place(lambda o: torch.cat(
            [sp.move(y, q, o) for q, y in parts]).reshape(h[0].shape)))
    return ys, aux


def _mesh_layer_apply(sps, i, xss, cfg, spec, positions):
    """Layer ``i`` of a config with experts over every data row: each
    row's attention over its slots, then the MoE of the whole batch."""
    pre = f"layers.{i}."
    xss = [_slot_mixer_half(sp, i, xs, cfg, spec, pos)
           for sp, xs, pos in zip(sps, xss, positions)]
    hs = [sp.normed(pre, "mlp_pre_norm", xs) for sp, xs in zip(sps, xss)]
    ys, aux = _mesh_moe(sps, i, hs, cfg)
    if cfg.post_norm:
        ys = [sp.normed(pre, "mlp_post_norm", y) for sp, y in zip(sps, ys)]
    return [sp.add(xs, y) for sp, xs, y in zip(sps, xss, ys)], aux


def _mesh_group_apply(sps, layers, specs, cfg, positions, aux, *flat):
    """Layers ``layers`` of every row (``flat``: the rows' streams, row
    after row); the aux summed on in layer order."""
    xss, k = [], 0
    for sp in sps:
        xss.append(list(flat[k:k + len(sp.owners)]))
        k += len(sp.owners)
    for i, spec in zip(layers, specs):
        xss, a = _mesh_layer_apply(sps, i, xss, cfg, spec, positions)
        with sps[0].slot(0):
            aux = aux + a
    return (aux,) + tuple(x for xs in xss for x in xs)


def mesh_loss(sps: list, cfg: ModelConfig, batches: list, weights: list):
    """``loss_fn`` of the whole batch of a config with experts over every
    data row's model slots (``sps[j]``: row j's ``SlotParams``,
    ``batches[j]`` its rows), the rows layer by layer together: each
    MoE layer's routing and capacity are the whole batch's
    (``_mesh_moe``).  The loss, on row 0's slot 0: the rows'
    cross-entropies weighted by ``weights`` (their shares of the batch's
    tokens) plus ``MOE_AUX_WEIGHT`` times the aux, the Switch loss of the
    whole batch summed over layers, added once."""
    inps = [_slot_inputs(sp, cfg, b) for sp, b in zip(sps, batches)]
    positions = [inp["positions"] for inp in inps]
    specs, n = layer_specs(cfg), len(cfg.pattern)
    home = sps[0]
    with full_fp32_matmul():
        flat = tuple(x for sp, inp in zip(sps, inps)
                     for x in _slot_embed(sp, cfg, inp))
        aux = 0.0
        for g in range(cfg.n_groups):
            aux, *flat = remat(cfg, _mesh_group_apply, sps,
                               range(g * n, (g + 1) * n),
                               specs[g * n:(g + 1) * n], cfg, positions,
                               aux, *flat)
        tail = range(cfg.n_groups * n, len(specs))
        aux, *flat = _mesh_group_apply(sps, tail, [specs[i] for i in tail],
                                       cfg, positions, aux, *flat)
        ce, k = 0.0, 0
        for sp, inp, w in zip(sps, inps, weights):
            part = _slot_ce(sp, cfg, list(flat[k:k + len(sp.owners)]),
                            inp["labels"])
            k += len(sp.owners)
            part = _move_between(part, sp, 0, home, 0)
            with home.slot(0):
                ce = ce + (part if w == 1.0 else part * w)
        with home.slot(0):
            total = ce + MOE_AUX_WEIGHT * aux
    return total, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def _cache_len_for(spec: LayerSpec, max_len: int) -> int:
    if spec.window is not None:
        return min(spec.window, max_len)               # ring cache
    return max_len


def _layer_cache_init(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      max_len: int, dtype, device):
    if spec.kind == "attn":
        t = _cache_len_for(spec, max_len)
        shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
        return {"mixer": {"k": torch.zeros(shape, dtype=dtype,
                                           device=device),
                          "v": torch.zeros(shape, dtype=dtype,
                                           device=device)},
                "ffn": ()}
    if spec.kind == "rglru":
        return {"mixer": rglru.rg_state_init(batch, cfg.rnn_dim,
                                             cfg.conv_width, dtype, device),
                "ffn": ()}
    if spec.kind == "rwkv":
        st = rwkv6.rwkv_state_init(batch, cfg.d_model, cfg.rwkv_head_size,
                                   device)
        return {"mixer": st["tm"], "ffn": st["cm"]}
    raise ValueError(spec.kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeroed caches, one entry per layer.  ``device=None``: the card."""
    dev = resolve_device(device)
    return [_layer_cache_init(spec, cfg, batch, max_len, cfg.compute_dtype,
                              dev) for spec in layer_specs(cfg)]


def _ring_positions(t_cache: int, q_pos, window: Optional[int]):
    """Absolute position stored in each ring-cache slot given query pos.

    Slot i holds the largest p <= q_pos-1 with p % T == i (T = cache
    size); empty slots map to -1 via the p >= 0 check in decode_attention.
    """
    i = torch.arange(t_cache, device=q_pos.device)[None, :]
    prev = q_pos[:, None] - 1                          # last written position
    return prev - torch.remainder(prev - i, t_cache)


def _attn_decode(p, x, cfg: ModelConfig, spec: LayerSpec, positions, state):
    """x [B, 1, d]; state {"k", "v" [B, T, hkv, hd]}.  positions [B, 1]
    (or [3, B, 1]): the token's absolute position."""
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    q_pos = (positions[0] if positions.dim() == 3 else positions)[:, 0]
    b, t_cache = x.shape[0], state["k"].shape[1]
    slot = torch.remainder(q_pos, t_cache)
    bidx = torch.arange(b, device=x.device)
    k_cache = state["k"].clone()
    v_cache = state["v"].clone()
    k_cache[bidx, slot] = k_new[:, 0]
    v_cache[bidx, slot] = v_new[:, 0]
    if spec.window is not None and t_cache <= spec.window:
        k_pos = _ring_positions(t_cache, q_pos + 1, spec.window)
    else:
        k_pos = torch.arange(t_cache, device=x.device)[None, :] \
            .expand(b, t_cache)
    out = decode_attention(q, k_cache, v_cache, q_pos, k_pos,
                           window=spec.window, logit_cap=cfg.attn_logit_cap,
                           scale=cfg.attn_scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, {"k": k_cache, "v": v_cache}


def _attn_retrieval_decode(p, x, cfg: ModelConfig, spec: LayerSpec,
                           positions, idx):
    """HNTL-KV long-context decode (the paper's Mode B as attention)."""
    from .hntl_attention import retrieval_decode_attention
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    q_pos = (positions[0] if positions.dim() == 3 else positions)[:, 0]
    out, new_idx = retrieval_decode_attention(q, k_new, v_new, idx, q_pos,
                                              cfg)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_idx


def _write_prefill_cache(cache, kv, seq_len: int):
    """Scatter prefill K/V into the (possibly ring) cache."""
    k, v = kv
    t_cache = cache["k"].shape[1]
    k_cache, v_cache = cache["k"], cache["v"]
    if seq_len <= t_cache:
        k_cache[:, :seq_len] = k
        v_cache[:, :seq_len] = v
    else:                                              # keep the last window
        slots = torch.remainder(
            torch.arange(seq_len - t_cache, seq_len, device=k.device),
            t_cache)
        k_cache[:, slots] = k[:, -t_cache:].to(k_cache.dtype)
        v_cache[:, slots] = v[:, -t_cache:].to(v_cache.dtype)
    return {"k": k_cache, "v": v_cache}


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens, positions=None,
            patch_embeds=None, max_len: Optional[int] = None):
    """Forward + cache build.  Returns (last-token logits [B, V], caches).

    max_len: cache capacity for later ``decode_step`` calls (>= the
    prompt's length; defaults to 2 * S so decoding can go past it).
    """
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    if max_len is None:
        max_len = 2 * s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is below the prompt's {s}")
    positions = _positions(params, cfg, positions, b, s)
    caches = []
    with full_fp32_matmul():
        x = _embed_tokens(params, cfg, tokens, patch_embeds)
        for lp, spec in zip(params.layers, layer_specs(cfg)):
            lc = _layer_cache_init(spec, cfg, b, max_len, cfg.compute_dtype,
                                   params.device)
            if spec.kind != "attn":        # a recurrent layer: zero state
                x, _, _, new_state = _layer_apply(lp, x, cfg, spec,
                                                  positions, lc)
                caches.append(new_state)
                continue
            x, _, kv, _ = _layer_apply(lp, x, cfg, spec, positions)
            caches.append({"mixer": _write_prefill_cache(lc["mixer"], kv, s),
                           "ffn": lc["ffn"]})
            del kv
        hidden = _final_hidden(params, cfg, x[:, -1:, :])
    return logits_fn(params, cfg, hidden)[:, 0, :], caches


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, token, caches, pos):
    """One serving step.  token [B], pos [B] (position of this token).

    Returns (logits [B, V], new caches).
    """
    token = _tokens(params, token)
    pos = torch.as_tensor(pos, device=params.device).long()
    b = token.shape[0]
    positions = pos[:, None]
    if cfg.mrope_sections is not None:
        positions = positions.expand(3, b, 1)
    new_caches = []
    with full_fp32_matmul():
        x = _embed_tokens(params, cfg, token[:, None])
        for lp, spec, lc in zip(params.layers, layer_specs(cfg), caches):
            x, _, _, new_state = _layer_apply(lp, x, cfg, spec, positions,
                                              lc)
            new_caches.append(new_state)
        hidden = _final_hidden(params, cfg, x)
    return logits_fn(params, cfg, hidden)[:, 0, :], new_caches
