"""Exact brute-force oracle (ground truth for recall measurements)."""
from __future__ import annotations

import numpy as np
import torch

from .types import SearchResult


def flat_search(x: torch.Tensor, q: torch.Tensor, topk: int = 10,
                chunk: int = 65536) -> SearchResult:
    """Exact L2^2 top-k over x [N, d] for q [Q, d], on x's device.

    The corpus is scanned in chunks of ``chunk`` rows (each chunk's
    [Q, chunk] distance block is the only large transient); per-chunk top-k
    survivors are merged at the end.  Ties at the k-th distance are not
    ordered.
    """
    q = q.to(device=x.device, dtype=torch.float32)
    q2 = torch.sum(q * q, dim=-1, keepdim=True)
    best_d, best_i = [], []
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk]
        d2 = q2 - 2.0 * (q @ xc.T) + torch.sum(xc * xc, dim=-1)[None, :]
        kk = min(topk, xc.shape[0])
        d, i = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        best_d.append(d)
        best_i.append(i + lo)
    d = torch.cat(best_d, dim=1)
    i = torch.cat(best_i, dim=1)
    d, pos = torch.sort(d, dim=1, stable=True)
    ids = torch.gather(i, 1, pos)[:, :topk]
    return SearchResult(ids=ids.to(torch.int32), dists=d[:, :topk])


def recall_at_k(pred_ids, true_ids) -> float:
    """Mean fraction of true top-k found in predicted top-k."""
    pred, true = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                  else np.asarray(a) for a in (pred_ids, true_ids))
    hits = 0
    for p, t in zip(pred, true):
        hits += len(set(p.tolist()) & set(t.tolist()))
    return hits / true.size
