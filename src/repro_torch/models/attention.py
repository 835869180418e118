"""Attention: the chunked (flash-style) prefill path and the decode path.

This package's copy of the JAX package's ``models/attention.py``.  The
chunked path walks the keys in ``kv_chunk`` blocks with an online-softmax
accumulator, so no [S, T] score matrix is made; it supports GQA, causal
masks, sliding windows and gemma2's logit soft-capping.  Scores, the
softmax and both products are float32 (``p_bf16``: the probabilities are
cast to bf16 before the PV product, accumulated in float32); outputs
return to the query's dtype.

The queries are cut into blocks too, so one block's scores stay under
``SCORE_BLOCK_ELEMENTS`` (a 32,768-token phi3-mini prefill would otherwise
hold 4.3 GB per score tensor).  Rows are independent, and a key chunk that
every row of a block masks (causal or window) adds exactly nothing to the
reference's accumulator (its probabilities are exp(-1e30 - m) = 0, or it
is washed out by exp(-1e30 - m) = 0 at the first visible chunk), so such
chunks are skipped where every row sees its own key (queries inside the
cache, no ``kv_valid_len``): the result is the reference's.  Under
``lowering.flags().attn_chunks`` the chunk is ``max(128, ceil(t /
attn_chunks))``, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import softcap
from .lowering import flags

NEG_INF = -1.0e30

#: Most float32 score elements one (query block, key chunk) step holds.
SCORE_BLOCK_ELEMENTS = 1 << 27


def _mask_bias(q_pos, k_pos, causal: bool, window):
    """Additive mask bias [..., S_q, S_k] from position tensors."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF)


def attention(q, k, v, *, causal: bool = True, window=None, logit_cap=None,
              q_offset: int = 0, kv_chunk: int = 1024, scale=None,
              kv_valid_len=None, p_bf16: bool = False):
    """Chunked multi-head attention.

    q [B, S, Hq, hd]; k, v [B, T, Hkv, hd]; Hq % Hkv == 0 (GQA).
    q_offset: absolute position of q[0].
    kv_valid_len: optional [B] number of valid key positions.
    Returns [B, S, Hq, hd].
    """
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = hd ** -0.5
    dev = q.device
    qf = (q.to(torch.float32) * scale).reshape(b, s, hkv, g, hd)
    q_pos = q_offset + torch.arange(s, device=dev)
    if flags().attn_chunks:              # the dry-run's chunk count
        kv_chunk = max(128, -(-t // flags().attn_chunks))
    kv_chunk = min(kv_chunk, t)
    n_chunks = max(1, -(-t // kv_chunk))
    t_pad = n_chunks * kv_chunk - t
    q_block = max(1, min(s, SCORE_BLOCK_ELEMENTS // (b * hq * kv_chunk)))
    skip = kv_valid_len is None and q_offset + s <= t
    out = torch.empty((b, s, hkv, g, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, s, q_block):
        q1 = min(s, q0 + q_block)
        qb, qpb = qf[:, q0:q1], q_pos[q0:q1]
        m = torch.full((b, q1 - q0, hkv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, q1 - q0, hkv, g, hd), dtype=torch.float32,
                          device=dev)
        for ci in range(n_chunks):
            k0 = ci * kv_chunk
            if skip and ((causal and k0 > q_offset + q1 - 1)
                         or (window is not None and k0 + kv_chunk - 1
                             <= q_offset + q0 - window)):
                continue
            k_i = k[:, k0:k0 + kv_chunk].to(torch.float32)
            v_i = v[:, k0:k0 + kv_chunk]
            if k_i.shape[1] < kv_chunk:          # the zero-padded last chunk
                pad = kv_chunk - k_i.shape[1]
                k_i = F.pad(k_i, (0, 0, 0, 0, 0, pad))
                v_i = F.pad(v_i, (0, 0, 0, 0, 0, pad))
            k_pos = k0 + torch.arange(kv_chunk, device=dev)
            sc = torch.einsum("bshgd,bthd->bshgt", qb, k_i)
            sc = softcap(sc, logit_cap)
            bias = _mask_bias(qpb, k_pos, causal, window)   # [S, kv_chunk]
            if t_pad:                            # mask chunk padding slots
                bias = bias + torch.where(k_pos < t, 0.0, NEG_INF)[None, :]
            sc = sc + bias[None, :, None, None, :]
            if kv_valid_len is not None:
                ok = k_pos[None, :] < kv_valid_len[:, None]  # [B, chunk]
                sc = sc + torch.where(ok, 0.0, NEG_INF)[:, None, None,
                                                        None, :]
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            if p_bf16:     # flash-attn convention: bf16 P, f32 accumulator
                pv = torch.einsum("bshgt,bthd->bshgd",
                                  p.to(torch.bfloat16).to(torch.float32),
                                  v_i.to(torch.float32))
            else:
                pv = torch.einsum("bshgt,bthd->bshgd", p,
                                  v_i.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, q0:q1] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, s, hq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, q_pos, k_pos, *, window=None,
                     logit_cap=None, scale=None):
    """Single-token decode: q [B, 1, Hq, hd] against cache [B, T, Hkv, hd].

    q_pos [B] — absolute position of the query token.
    k_pos [B, T] — absolute position held by each cache slot (-1 = empty).
    Single pass: scores are [B, Hq, T].
    """
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = hd ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(b, hkv, g, hd)
    sc = torch.einsum("bhgd,bthd->bhgt", qf, k_cache.to(torch.float32))
    sc = softcap(sc, logit_cap)
    ok = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos > (q_pos[:, None] - window))
    sc = torch.where(ok[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, hd).to(q.dtype)
