"""Exact decode attention: the oracle HNTL-KV retrieval is held against.

This package's copy of the JAX package's ``models/attention.py``
``decode_attention``; the chunked prefill path (and ``_mask_bias``, which
only it uses) comes with the transformer.  Scores and the softmax are
float32, outputs return to the query's dtype.
"""
from __future__ import annotations

import torch

from .common import softcap

NEG_INF = -1.0e30


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
