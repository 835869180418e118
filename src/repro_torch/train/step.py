"""Training step: gradient accumulation over microbatches, AdamW, metrics.

This package's port of the JAX package's ``train/step.py``.  Where the
reference jit-compiles ``value_and_grad`` of ``Model.loss``, the step
here runs the loss forward and ``torch.autograd.grad`` eagerly, both
inside ``core.index.full_fp32_matmul`` (float32 products without TF32,
bf16 products reduced in float32; remat's recomputation runs inside the
backward pass, so it is covered too).  Gradients are cast to float32
(leaf by leaf, each low-precision gradient freed as its copy is made)
before the update; over microbatches they are accumulated in float32 and
averaged, as the reference's scan does.  The optimizer updates the
parameters in place (``optim.adamw``), so a step returns the same module
in a new ``TrainState``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.index import full_fp32_matmul


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt_state: dict
    step: int


def init_state(model, optimizer, seed_or_generator=0,
               device=None) -> TrainState:
    """A new model (``Model.init``: ``device=None`` is the card) with
    gradients turned on, and the optimizer's state for it."""
    params = model.init(seed_or_generator, device=device)
    params.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def _split_microbatches(batch, n: int) -> list:
    """{name: [B, ...]} -> n batches of B // n rows."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch[{k!r}] has {b} rows, which do not "
                             f"split into {n} microbatches")
        for i, part in enumerate(torch.as_tensor(x).reshape(
                (n, b // n) + tuple(x.shape[1:]))):
            out[i][k] = part
    return out


def _detach(metrics: dict) -> dict:
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in metrics.items()}


def value_and_grad(model, params, batch):
    """(loss, metrics, {name: float32 gradient}) of ``model.loss``."""
    names, leaves = zip(*params.named_parameters())
    loss, metrics = model.loss(params, batch)
    grads = list(torch.autograd.grad(loss, leaves))
    out = {}
    for i, name in enumerate(names):
        out[name] = grads[i].to(torch.float32)
        grads[i] = None            # free each gradient as its copy is made
    return loss.detach(), _detach(metrics), out


def make_train_step(model, optimizer, *, microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch):
        with full_fp32_matmul():
            if microbatches == 1:
                loss, metrics, grads = value_and_grad(model, state.params,
                                                      batch)
            else:
                grads, lsum = None, 0.0
                for mb in _split_microbatches(batch, microbatches):
                    loss, _, g = value_and_grad(model, state.params, mb)
                    if grads is None:
                        grads = {k: torch.zeros_like(v) for k, v in
                                 g.items()}
                    for k, v in g.items():
                        grads[k].add_(v)
                    del g
                    lsum = lsum + loss
                inv = 1.0 / microbatches
                for v in grads.values():
                    v.mul_(inv)
                loss = lsum * inv
                metrics = {"ce": loss, "aux": 0.0}
        params, opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params)
        del grads
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
