"""Shared model pieces (only what HNTL-KV needs so far)."""
from __future__ import annotations

import torch


def softcap(x: torch.Tensor, cap):
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
