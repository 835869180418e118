"""HNTL-KV retrieval attention: the paper's Mode B as long-context decode.

This package's port of the JAX package's ``models/hntl_attention.py``.

For 500k-token decoding, scanning the full KV cache per step is
memory-bandwidth-bound (500k x hd reads per head per layer).  HNTL-KV
replaces it with the paper's two-level route-then-scan:

  sealed region (positions [0, S)): contiguous ``kv_cap``-token chunks are
    *grains*.  Each grain holds a centroid, a local tangent basis over its
    (post-RoPE) keys, int16 quantized coordinates in Block-SoA layout and
    int32 residual energies.  A decode query routes to its top-P grains
    (+ the quantization envelope filter), scans their panels with integer
    math (``kernels.ops.scan_single``: the CUDA kernel on the card) and
    re-ranks the top-C candidates exactly against the raw keys.
  hot tail (positions [S, S+Wt)): a ring buffer scanned exactly.  Decode
    steps append here; ``seal_tail`` freezes full chunks into new grains.

Grains index keys under L2; attention wants large q.k.  The pool is
re-scored with exact dot products inside the softmax, so the approximation
only decides which tokens enter the pool.

Porting notes: every top-n is a stable ascending sort (ties to the lower
index, as ``jax.lax.top_k`` of the negated values); ``torch.linalg.eigh``
is ascending like ``jnp.linalg.eigh`` and is flipped the same way, but its
eigenvector signs may differ from JAX's, so two builds agree on projectors
(basis basis^T), not on coordinates.  Float32 products run with TF32 off.
``kv_index_specs`` makes an index of meta tensors (shapes and dtypes, no
bytes) for the dry-run (``launch.specs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.index import full_fp32_matmul, int32_safe_qmax, resolve_device
from ..core.quantize import _masked_quantile
from ..core.types import BIG
from ..kernels import ops
from .attention import decode_attention
from .common import softcap

NEG_INF = -1.0e30

#: Grains per batched step of ``build_kv_index``: bounds its float32
#: working set (keys, centred keys) to 2 x chunk x cap x hd x 4 bytes.
BUILD_CHUNK = 1024


@dataclasses.dataclass(frozen=True)
class KVIndex:
    """Per-layer HNTL index over one attention layer's key cache.

    Shapes: B batch, KV kv-heads, G grains, hd head dim, kt tangent dim,
    cap tokens/grain, S = G*cap sealed tokens, Wt tail slots.
    """

    centroids: torch.Tensor    # [B, KV, G, hd] f32 (bf16: kv_bf16_meta)
    basis: torch.Tensor        # [B, KV, G, hd, kt] f32 (bf16: kv_bf16_meta)
    coords: torch.Tensor       # [B, KV, G, kt, cap] i16 (Block-SoA)
    res: torch.Tensor          # [B, KV, G, cap] i32
    scale: torch.Tensor        # [B, KV, G] f32
    res_scale: torch.Tensor    # [B, KV, G] f32
    k_raw: torch.Tensor        # [B, S, KV, hd] — cold tier (exact re-rank);
    v_raw: torch.Tensor        #   int8 when cfg.kv_sq8 (paper §4 SQ8 tier)
    tail_k: torch.Tensor       # [B, Wt, KV, hd] — hot memtable ring
    tail_v: torch.Tensor       # [B, Wt, KV, hd]
    k_scale: Optional[torch.Tensor] = None   # [B, KV] sq8 dequant scales
    v_scale: Optional[torch.Tensor] = None

    @property
    def n_grains(self) -> int:
        return self.centroids.shape[2]

    @property
    def cap(self) -> int:
        return self.coords.shape[-1]

    @property
    def sealed_len(self) -> int:
        return self.k_raw.shape[1]

    @property
    def device(self) -> torch.device:
        return self.coords.device


def kv_index_specs(cfg, batch: int, sealed_len: int,
                   dtype=torch.bfloat16) -> KVIndex:
    """A ``KVIndex`` of meta tensors with the shapes and dtypes that
    ``build_kv_index`` gives a [batch, sealed_len, KV, hd] cache of
    ``dtype`` (the dry-run's stand-in: no allocation).  bf16 centroids
    and bases under ``cfg.kv_bf16_meta``; int8 raw tiers and float32
    [batch, KV] scales under ``cfg.kv_sq8``."""
    kv, hd, kt, cap = cfg.n_kv_heads, cfg.head_dim, cfg.kv_kt, cfg.kv_cap
    g = sealed_len // cap
    meta_dt = torch.bfloat16 if cfg.kv_bf16_meta else torch.float32
    raw_dt = torch.int8 if cfg.kv_sq8 else dtype

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    scales = {}
    if cfg.kv_sq8:
        scales = {"k_scale": meta((batch, kv), torch.float32),
                  "v_scale": meta((batch, kv), torch.float32)}
    return KVIndex(
        centroids=meta((batch, kv, g, hd), meta_dt),
        basis=meta((batch, kv, g, hd, kt), meta_dt),
        coords=meta((batch, kv, g, kt, cap), torch.int16),
        res=meta((batch, kv, g, cap), torch.int32),
        scale=meta((batch, kv, g), torch.float32),
        res_scale=meta((batch, kv, g), torch.float32),
        k_raw=meta((batch, sealed_len, kv, hd), raw_dt),
        v_raw=meta((batch, sealed_len, kv, hd), raw_dt),
        tail_k=meta((batch, cfg.kv_tail, kv, hd), dtype),
        tail_v=meta((batch, cfg.kv_tail, kv, hd), dtype),
        **scales)


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _build_grains(keys: torch.Tensor, kt: int, qmax: int):
    """keys [N, cap, hd] f32 -> N grains' (mu [N, hd], basis [N, hd, kt],
    coords [N, kt, cap] i16, res [N, cap] i32, scale [N], res_scale [N])."""
    n, cap, _ = keys.shape
    mu = torch.mean(keys, dim=1)
    xc = keys - mu[:, None, :]
    cov = torch.matmul(xc.transpose(1, 2), xc) / cap
    _, vecs = torch.linalg.eigh(cov)                         # ascending
    basis = torch.flip(vecs, dims=(-1,))[:, :, :kt].contiguous()
    z = torch.matmul(xc, basis)                              # [N, cap, kt]
    # jnp.quantile(|z|, 0.9995) per grain, in its float32 arithmetic
    mag = torch.abs(z).reshape(n, cap * kt)
    mag = _masked_quantile(mag, torch.ones_like(mag, dtype=torch.bool),
                           0.9995)
    scale = torch.clamp(mag * 1.25, min=1e-12) / qmax
    zq = torch.clamp(torch.round(z / scale[:, None, None]), -qmax,
                     qmax).to(torch.int16)
    r = torch.clamp(torch.sum(xc * xc, dim=2) - torch.sum(z * z, dim=2),
                    min=0.0)
    res_scale = torch.clamp(torch.amax(r, dim=1) * 1.05, min=1e-12) / 65535
    rq = torch.clamp(torch.round(r / res_scale[:, None]), 0,
                     65535).to(torch.int32)
    return (mu, basis, zq.transpose(1, 2).contiguous(), rq, scale,
            res_scale)


def _sq8(raw: torch.Tensor):
    """Per-(batch, kv-head) int8 quantization of a [B, S, KV, hd] tier."""
    f = raw.to(torch.float32)
    sc = torch.amax(torch.abs(f), dim=(1, 3)) / 127.0 + 1e-12    # [B, KV]
    q = torch.clamp(torch.round(f / sc[:, None, :, None]), -127, 127)
    return q.to(torch.int8), sc


def build_kv_index(k_raw, v_raw, cfg, *, device=None) -> KVIndex:
    """Seal a [B, S, KV, hd] key cache into an HNTL-KV index.

    S must be a multiple of cfg.kv_cap.  Post-RoPE keys expected.  The
    grains are built in float32 whatever the cache's dtype (bf16 for
    phi3), ``BUILD_CHUNK`` grains at a time.  ``device=None`` builds on
    the card (raising if there is none); tensors already there stay.
    """
    dev = resolve_device(device)
    k_raw = torch.as_tensor(k_raw, device=dev)
    v_raw = torch.as_tensor(v_raw, device=dev)
    b, s, kv, hd = k_raw.shape
    cap, kt = cfg.kv_cap, cfg.kv_kt
    if s % cap:
        raise ValueError(f"sealed length {s} is not a multiple of kv_cap "
                         f"{cap}")
    g = s // cap
    qmax = int32_safe_qmax(kt)
    out = dict(
        centroids=torch.empty((b, kv, g, hd), dtype=torch.float32,
                              device=dev),
        basis=torch.empty((b, kv, g, hd, kt), dtype=torch.float32,
                          device=dev),
        coords=torch.empty((b, kv, g, kt, cap), dtype=torch.int16,
                           device=dev),
        res=torch.empty((b, kv, g, cap), dtype=torch.int32, device=dev),
        scale=torch.empty((b, kv, g), dtype=torch.float32, device=dev),
        res_scale=torch.empty((b, kv, g), dtype=torch.float32, device=dev))
    names = ("centroids", "basis", "coords", "res", "scale", "res_scale")
    grains = k_raw.reshape(b, g, cap, kv, hd).permute(0, 3, 1, 2, 4)
    heads = max(1, BUILD_CHUNK // max(g, 1))
    with full_fp32_matmul():
        for bi in range(b):
            for h0 in range(0, kv, heads):
                h1 = min(kv, h0 + heads)
                keys = grains[bi, h0:h1].reshape(-1, cap, hd) \
                    .to(torch.float32)
                for name, v in zip(names, _build_grains(keys, kt, qmax)):
                    out[name][bi, h0:h1] = v.reshape(
                        (h1 - h0, g) + tuple(v.shape[1:]))
    if cfg.kv_bf16_meta:
        out["centroids"] = out["centroids"].to(torch.bfloat16)
        out["basis"] = out["basis"].to(torch.bfloat16)
    tail_dt = k_raw.dtype
    k_sc = v_sc = None
    if cfg.kv_sq8:          # paper §4: SQ8 cold-tier offloading
        k_raw, k_sc = _sq8(k_raw)
        v_raw, v_sc = _sq8(v_raw)
    wt = cfg.kv_tail
    return KVIndex(
        **out, k_raw=k_raw, v_raw=v_raw,
        tail_k=torch.zeros((b, wt, kv, hd), dtype=tail_dt, device=dev),
        tail_v=torch.zeros((b, wt, kv, hd), dtype=tail_dt, device=dev),
        k_scale=k_sc, v_scale=v_sc)


# ---------------------------------------------------------------------------
# The retrieval decode path
# ---------------------------------------------------------------------------


def _smallest(x: torch.Tensor, n: int):
    """Stable ascending top-n along the last axis: (values, positions)."""
    v, pos = torch.sort(x, dim=-1, stable=True)
    return v[..., :n], pos[..., :n]


def _probe(qh, idx: KVIndex, cfg):
    """Levels 1-2 of a retrieval: route each query to its nprobe nearest
    grains, gather their panels, project and quantize the query into each
    grain's frame and take the envelope verdict.

    qh [B, KV, gq, hd] f32.  Returns (gsel [B, KV, gq, P], keep_grain
    [B, KV, gq, P], scan_args): ``scan_args`` are the P' = B*KV*gq*P
    independent pairs ``ops.scan_single`` takes, (zq [P', kt] i32,
    rq [P'] f32, coords [P', kt, cap] i16, res [P', cap] i32,
    valid [P', cap] bool, scale [P'], res_scale [P']).
    """
    b, kv, gq, hd = qh.shape
    g, kt, cap = idx.n_grains, cfg.kv_kt, idx.cap
    nprobe = min(cfg.kv_nprobe, g)
    qmax = int32_safe_qmax(kt)
    dev = qh.device

    # ---- level 1: centroid routing (paper 2.3) ---------------------------
    cent = idx.centroids                                   # [B,KV,G,hd]
    d2 = (torch.sum(qh * qh, -1)[..., None]
          - 2.0 * torch.einsum("bkgh,bkGh->bkgG", qh, cent.to(torch.float32))
          + torch.sum(cent * cent, -1)[:, :, None, :])     # [B,KV,gq,G]
    _, gsel = _smallest(d2, nprobe)                        # [B,KV,gq,P]

    # ---- gather the probed grain panels ----------------------------------
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ki = torch.arange(kv, device=dev)[None, :, None, None]

    def takeg(arr):
        """arr [B,KV,G,...] -> [B,KV,gq,P,...] gathered at gsel."""
        return arr[bi, ki, gsel]

    mu_s = takeg(idx.centroids)                            # [B,KV,gq,P,hd]
    basis_s = takeg(idx.basis)                             # [...,hd,kt]
    coords_s = takeg(idx.coords)                           # [...,kt,cap]
    res_s = takeg(idx.res)                                 # [...,cap]
    scale_s = takeg(idx.scale)                             # [B,KV,gq,P]
    rscale_s = takeg(idx.res_scale)

    # ---- level 2: tangent projection + envelope filter -------------------
    vc = qh[:, :, :, None, :] - mu_s.to(torch.float32)    # [B,KV,gq,P,hd]
    z = torch.einsum("bkgph,bkgphT->bkgpT", vc,
                     basis_s.to(torch.float32))            # [...,kt]
    rq = torch.clamp(torch.sum(vc * vc, -1) - torch.sum(z * z, -1), min=0.0)
    zs = z / scale_s[..., None]
    sat = torch.mean((torch.abs(zs) >= qmax).to(torch.float32), dim=-1)
    keep_grain = sat <= cfg.kv_envelope_frac               # [B,KV,gq,P]
    # fallback: never prune *all* routed grains (keep the nearest one)
    none_kept = ~torch.any(keep_grain, dim=-1, keepdim=True)
    first = torch.arange(nprobe, device=dev) == 0
    keep_grain = keep_grain | (none_kept & first)
    zq = torch.clamp(torch.round(zs), -qmax, qmax).to(torch.int32)

    pn = b * kv * gq * nprobe
    scan_args = (zq.reshape(pn, kt), rq.reshape(pn),
                 coords_s.reshape(pn, kt, cap), res_s.reshape(pn, cap),
                 torch.ones((pn, cap), dtype=torch.bool, device=dev),
                 scale_s.reshape(pn), rscale_s.reshape(pn))
    return gsel, keep_grain, scan_args


def _retrieve_pool(qh, idx: KVIndex, cfg, *, scan_backend: str = "auto"):
    """Route -> envelope filter -> Block-SoA scan -> top-C exact candidates.

    qh [B, KV, gq, hd] f32 queries (grouped onto kv heads).
    Returns (log_c [B, KV, gq, C] exact dot-product logits, v_cand
    [B, KV, gq, C, hd], C, token_pos [B, KV, gq, C]).
    """
    b, kv, gq, hd = qh.shape
    cap = idx.cap
    nprobe = min(cfg.kv_nprobe, idx.n_grains)
    pool = min(cfg.kv_pool, nprobe * cap)
    scale_attn = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    dev = qh.device
    gsel, keep_grain, scan_args = _probe(qh, idx, cfg)

    # ---- Block-SoA integer scan (the paper's engine) ---------------------
    dists = ops.scan_single(*scan_args, backend=scan_backend)
    dists = dists.reshape(b, kv, gq, nprobe, cap)
    dists = torch.where(keep_grain[..., None], dists, BIG)

    # ---- top-C candidate pool -> exact re-rank (Mode B) ------------------
    d_sel, pos_sel = _smallest(dists.reshape(b, kv, gq, nprobe * cap), pool)
    token_pos = torch.gather(gsel, -1, pos_sel // cap) * cap \
        + pos_sel % cap                                    # [B,KV,gq,C]
    cand_ok = d_sel < BIG / 2

    bi = torch.arange(b, device=dev)[:, None, None, None]
    ki = torch.arange(kv, device=dev)[None, :, None, None]
    k_cand = idx.k_raw[bi, token_pos, ki]                  # [B,KV,gq,C,hd]
    v_cand = idx.v_raw[bi, token_pos, ki]
    if idx.k_scale is not None:                            # sq8 dequant
        k_cand = k_cand.to(torch.float32) \
            * idx.k_scale[:, :, None, None, None]
        v_cand = v_cand.to(torch.float32) \
            * idx.v_scale[:, :, None, None, None]

    qs = qh * scale_attn
    log_c = torch.einsum("bkgh,bkgch->bkgc", qs, k_cand.to(torch.float32))
    log_c = softcap(log_c, cfg.attn_logit_cap)
    log_c = torch.where(cand_ok, log_c, NEG_INF)
    return log_c, v_cand, pool, token_pos


def retrieval_decode_attention(q, k_new, v_new, idx: KVIndex, q_pos, cfg,
                               *, scan_backend: str = "auto"):
    """One-token attention over (sealed HNTL index + exact hot tail).

    q, k_new, v_new [B, 1, H*, hd] (post-RoPE); q_pos [B] absolute position.
    Returns (out [B, 1, Hq, hd], updated KVIndex with the token in the
    tail).  The input index is not modified.
    """
    b, _, hq, hd = q.shape
    kv = idx.centroids.shape[1]
    gq = hq // kv
    s_sealed = idx.sealed_len
    wt = idx.tail_k.shape[1]
    scale_attn = cfg.attn_scale if cfg.attn_scale is not None else hd ** -0.5
    dev = q.device
    q_pos = torch.as_tensor(q_pos, device=dev)

    # ---- tail append (the memtable write) --------------------------------
    slot = torch.remainder(q_pos - s_sealed, wt).long()
    bidx = torch.arange(b, device=dev)
    tail_k = idx.tail_k.clone()
    tail_v = idx.tail_v.clone()
    tail_k[bidx, slot] = k_new[:, 0].to(tail_k.dtype)
    tail_v[bidx, slot] = v_new[:, 0].to(tail_v.dtype)

    with full_fp32_matmul():
        qh = q[:, 0].to(torch.float32).reshape(b, kv, gq, hd)
        log_c, v_cand, pool, _ = _retrieve_pool(qh, idx, cfg,
                                                scan_backend=scan_backend)
        qs = qh * scale_attn

        # ---- exact hot-tail logits (the unsealed memtable) ---------------
        i_slot = torch.arange(wt, device=dev)[None, :]
        prev = q_pos[:, None]
        tpos = prev - torch.remainder(prev - (i_slot + s_sealed), wt)
        tail_ok = (tpos >= s_sealed) & (tpos <= prev)      # [B, Wt]
        tk = tail_k.to(torch.float32).transpose(1, 2)      # [B,KV,Wt,hd]
        tv = tail_v.to(torch.float32).transpose(1, 2)
        log_t = torch.einsum("bkgh,bkth->bkgt", qs, tk)
        log_t = softcap(log_t, cfg.attn_logit_cap)
        log_t = torch.where(tail_ok[:, None, None, :], log_t, NEG_INF)

        # ---- fused softmax over pool + tail ------------------------------
        logits = torch.cat([log_c, log_t], dim=-1)         # [B,KV,gq,C+Wt]
        p = torch.softmax(logits, dim=-1)
        out = (torch.einsum("bkgc,bkgch->bkgh", p[..., :pool],
                            v_cand.to(torch.float32))
               + torch.einsum("bkgt,bkth->bkgh", p[..., pool:], tv))
    out = out.reshape(b, 1, hq, hd).to(q.dtype)
    return out, dataclasses.replace(idx, tail_k=tail_k, tail_v=tail_v)


def retrieval_cross_attention(q, idx: KVIndex, cfg, *,
                              scan_backend: str = "auto"):
    """Attention over a *static* sealed memory (whisper cross-attention).

    q [B, 1, Hq, hd]; no tail append — encoder memory never grows.
    Returns out [B, 1, Hq, hd].
    """
    b, _, hq, hd = q.shape
    kv = idx.centroids.shape[1]
    gq = hq // kv
    with full_fp32_matmul():
        qh = q[:, 0].to(torch.float32).reshape(b, kv, gq, hd)
        log_c, v_cand, _, _ = _retrieve_pool(qh, idx, cfg,
                                             scan_backend=scan_backend)
        p = torch.softmax(log_c, dim=-1)
        out = torch.einsum("bkgc,bkgch->bkgh", p, v_cand.to(torch.float32))
    return out.reshape(b, 1, hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Control plane: seal the hot tail into new grains (between steps)
# ---------------------------------------------------------------------------


def seal_tail(idx: KVIndex, tail_len: int, cfg) -> KVIndex:
    """Freeze full cap-sized chunks of the tail into new sealed grains.

    Mirrors Aperon's memtable seal: immutable append, no re-wiring of
    existing grains.  Returns a new (larger) KVIndex.  An SQ8 index is
    refused: the JAX package's seal drops the dequant scales and mixes raw
    and quantized tokens in one tier (see ROADMAP, Queue C).
    """
    if idx.k_scale is not None:
        raise ValueError("seal_tail does not take an SQ8 (kv_sq8) index")
    cap = cfg.kv_cap
    n_new = tail_len // cap
    if n_new == 0:
        return idx
    take = n_new * cap
    k_new = idx.tail_k[:, :take]
    v_new = idx.tail_v[:, :take]
    sub = build_kv_index(k_new, v_new, cfg, device=idx.device)

    def shifted(t):
        return torch.cat([t[:, take:], torch.zeros_like(t[:, :take])], dim=1)

    def grown(name):
        return torch.cat([getattr(idx, name), getattr(sub, name)], dim=2)

    return KVIndex(
        centroids=grown("centroids"), basis=grown("basis"),
        coords=grown("coords"), res=grown("res"), scale=grown("scale"),
        res_scale=grown("res_scale"),
        k_raw=torch.cat([idx.k_raw, k_new], dim=1),
        v_raw=torch.cat([idx.v_raw, v_new], dim=1),
        tail_k=shifted(idx.tail_k), tail_v=shifted(idx.tail_v))


def reference_decode_attention(q, k_all, v_all, q_pos, cfg):
    """Exact full-cache decode attention (the oracle HNTL-KV approximates).

    q [B,1,Hq,hd]; k_all/v_all [B,T,KV,hd] hold positions [0, q_pos]."""
    b, t = q.shape[0], k_all.shape[1]
    q_pos = torch.as_tensor(q_pos, device=q.device)
    k_pos = torch.arange(t, device=q.device)[None].expand(b, t)
    with full_fp32_matmul():
        return decode_attention(q, k_all, v_all, q_pos, k_pos,
                                logit_cap=cfg.attn_logit_cap,
                                scale=cfg.attn_scale)
