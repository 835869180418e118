"""AdamW + schedules + global-norm clipping.

This package's port of the JAX package's ``optim/adamw.py``, in its
float32 op order: moments are float32 whatever the parameter's dtype, the
update is computed in float32 (``p - lr * (step + wd * p)``, with ``eps``
added to ``sqrt(v_hat)``) and cast back to the parameter's dtype.  The
API keeps the reference's ``init(params)`` / ``update(grads, state,
params)`` shape, with two differences that memory forces (phi3-mini's
3.8 B parameters and their moments take 38 GB; a functional copy of them
would not fit beside them):

- parameters and moments are updated in place, under ``torch.no_grad``;
  ``update`` returns the same module and moment tensors;
- gradients and moments are keyed by parameter name
  (``named_parameters``), not by a pytree.

Schedules and the bias corrections are float32 scalars computed on the
host (0-d CPU tensors, as JAX's float32 scalars); the global norm and the
clip scale stay on the gradients' device.

Weight decay skips 1-d parameters (norm scales, 1-d biases) by each
parameter's own ``ndim``.  The reference tests ``ndim`` on its stacked
groups, where a layer's norm scale is [n_groups, d], so it decays the
norm scales inside its groups and not those of its tail or
``final_norm`` (ROADMAP, faults of the reference).
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Callable, Optional

import torch

from ..distributed.sharding import leaf_pieces, zeros_like_leaf


def _f32(x) -> torch.Tensor:
    """A float32 scalar on the host."""
    return torch.tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    def schedule(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float) -> Callable:
    return lambda step: _f32(lr)


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------


def global_norm(grads: Mapping) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, summed leaf by
    leaf in order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in grads.values()))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping, max_norm: float):
    """(grads scaled to global norm at most ``max_norm``, the norm): each
    leaf scaled in float32 and cast back to its dtype."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable                      # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: Optional[float] = 1.0

    def init(self, params) -> dict:
        """{"m", "v": {name: float32 zeros}, "count": 0}; placed as the
        parameters are where they lie on a mesh (``PlacedModule``)."""
        zeros = lambda: {k: zeros_like_leaf(p, torch.float32)  # noqa: E731
                         for k, p in params.named_parameters()}
        return {"m": zeros(), "v": zeros(), "count": 0}

    @torch.no_grad()
    def update(self, grads: Mapping, opt_state: dict, params):
        """One step in place: ``params`` and the moments of ``opt_state``
        are overwritten.  Returns (params, new opt_state, metrics).

        ``params`` may be a ``distributed.sharding.PlacedModule``: then
        each piece of a leaf (the whole leaf on a device, or one block)
        takes its slice of the gradient, moved to its device, and is
        updated by the same elementwise ops."""
        gnorm = global_norm(grads)
        scale = None
        if self.max_grad_norm is not None:
            scale = _clip_scale(gnorm, self.max_grad_norm)
        count = int(opt_state["count"]) + 1
        cf = _f32(count)
        lr = float(self.lr(count))
        bc1 = float(1.0 - self.b1 ** cf)
        bc2 = float(1.0 - self.b2 ** cf)
        m_all, v_all = opt_state["m"], opt_state["v"]
        for name, p in params.named_parameters():
            # decoupled weight decay: skip 1-d params (norms, biases)
            wd = self.weight_decay if p.dim() >= 2 else 0.0
            for pt, mt, vt, g in leaf_pieces(p, m_all[name], v_all[name],
                                             grad=grads[name]):
                sc = scale if scale is None or scale.device == pt.device \
                    else scale.to(pt.device)
                self._update_leaf(pt, g, mt, vt, sc, lr, bc1, bc2, wd)
        new_state = {"m": m_all, "v": v_all, "count": count}
        return params, new_state, {"grad_norm": gnorm, "lr": lr}

    def _update_leaf(self, p, g, m, v, scale, lr, bc1, bc2, wd):
        gf = g.to(torch.float32)
        if scale is not None:
            gf = (gf * scale).to(g.dtype).to(torch.float32)
        m.mul_(self.b1).add_((1 - self.b1) * gf)
        v.mul_(self.b2).add_((1 - self.b2) * gf * gf)
        step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        del gf
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (step + wd * pf))
