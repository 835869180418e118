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

On a mesh (a state placed by ``place_train_state``, or any state under
``distributed.sharding.use_rules`` whose mesh has more than one slot)
the step equals the one-device step on the same global batch, as the
reference's pjit step computes its one-device function:

- parameters and moments lie on the slots by ``infer_param_specs``;
- the batch splits over the rules' "batch" axes (the data axis, or pod
  and data), one row group per data row, each computed on its row's
  device with the whole parameters (``PlacedModule.module_on``: the
  placed leaves themselves where that device holds them whole);
- the loss is a token mean over the whole batch: each row's masked mean
  is weighted by its token count over the batch's count (never a mean
  of the rows' means: with padding those differ), and so is its
  gradient;
- a config with experts runs its whole batch as one row group: MoE's
  capacity takes the whole batch's token count and its aux is a mean
  over all tokens, so the data axis places its storage only;
- the rows' float32 gradients are summed on the first row's device and
  each piece of the state is updated in place with its slice;
- microbatches split the global batch as on one device, and each
  microbatch splits over the rows.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.index import full_fp32_matmul
from ..distributed.sharding import (PlacedModule, ShardingRules,
                                    active_rules, infer_param_shardings,
                                    place_module, place_tree)


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


def place_train_state(state: TrainState,
                      rules: ShardingRules) -> TrainState:
    """``state`` on ``rules.mesh``: parameters and both moments split by
    ``infer_param_specs`` (on a mesh whose slots share one device, the
    leaves themselves, shards as views)."""
    opt = state.opt_state
    return TrainState(
        params=place_module(state.params, rules),
        opt_state={"m": place_tree(opt["m"], rules),
                   "v": place_tree(opt["v"], rules), "count": opt["count"]},
        step=state.step)


def state_shardings(state: TrainState, rules: ShardingRules) -> TrainState:
    """The tree of shardings that ``CheckpointManager.restore(state,
    shardings=)`` takes to read ``state``'s checkpoint onto
    ``rules.mesh``."""
    opt = state.opt_state
    return TrainState(
        params=infer_param_shardings(state.params, rules),
        opt_state={"m": infer_param_shardings(opt["m"], rules),
                   "v": infer_param_shardings(opt["v"], rules),
                   "count": None},
        step=None)


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


def row_groups(model, rules: ShardingRules, batch) -> list:
    """[(device, rows)] of the step on ``rules.mesh``: the batch's dim 0
    split over the "batch" axes where they divide it (else one group, as
    the reference's fallback replicates), each group on the device of the
    first slot of its data row.  One group for a config with experts."""
    mesh = rules.mesh
    b = torch.as_tensor(batch["labels"]).shape[0]
    axes = None if model.cfg.n_experts else \
        rules.spec_for_shape((b,), ("batch",))[0]
    if axes is None:
        return [(mesh.device_at(mesh.coords()[0]), slice(0, b))]
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = rules.axis_size(axes)
    devs: dict = {}
    for c in mesh.coords():
        pos = dict(zip(mesh.axis_names, c))
        j = 0
        for a in axes:
            j = j * mesh.shape[a] + pos[a]
        devs.setdefault(j, mesh.device_at(c))
    return [(devs[j], slice(j * (b // n), (j + 1) * (b // n)))
            for j in range(n)]


def _tokens(batch, rows) -> int:
    return int((torch.as_tensor(batch["labels"])[rows] >= 0).sum())


def _rows_of(name: str, x, rows: slice, dev) -> torch.Tensor:
    """Rows ``rows`` of one batch leaf on ``dev``: dim 0, or dim 1 of
    M-RoPE's [3, B, S] position streams."""
    x = torch.as_tensor(x)
    if name == "positions" and x.dim() == 3:
        return x[:, rows].to(dev)
    return x[rows].to(dev)


def value_and_grad(model, params, batch, acc=None):
    """(loss, metrics, {name: float32 gradient}) of ``model.loss`` over
    the whole batch, the gradients summed into ``acc`` when given.  A
    module is one group on its own device; a ``PlacedModule`` computes
    per row group of its rules' mesh, each row's masked token mean
    weighted by its share of the batch's tokens, summed on the first
    group's device."""
    if isinstance(params, PlacedModule):
        groups = row_groups(model, params.rules, batch)
        module_on = params.module_on
    else:
        groups = [(next(params.parameters()).device, None)]
        module_on = lambda dev: params  # noqa: E731
    counts = [_tokens(batch, rows) for _, rows in groups] \
        if len(groups) > 1 else [1]
    total = max(sum(counts), 1)
    home = groups[0][0]
    loss, ce, aux = 0.0, 0.0, 0.0
    acc = {} if acc is None else acc
    for (dev, rows), count in zip(groups, counts):
        w = 1.0 if len(groups) == 1 else count / total
        module = module_on(dev)
        part = batch if rows is None else {
            k: _rows_of(k, v, rows, dev) for k, v in batch.items()}
        names, leaves = zip(*module.named_parameters())
        part_loss, metrics = model.loss(module, part)
        grads = list(torch.autograd.grad(
            part_loss if w == 1.0 else part_loss * w, leaves))
        for i, name in enumerate(names):
            g = grads[i]
            grads[i] = None        # free each gradient as it is summed
            if name in acc:
                acc[name].add_(g.to(home))
            else:
                acc[name] = g.to(device=home, dtype=torch.float32)
            del g
        loss = loss + w * part_loss.detach().to(home)
        ce = ce + w * metrics["ce"].detach().to(home)
        a = metrics["aux"]
        aux = aux + (a.detach().to(home) if torch.is_tensor(a) else a)
    return loss, {"ce": ce, "aux": aux}, acc


def make_train_step(model, optimizer, *, microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).  A placed
    state, or any state under active rules whose mesh has more than one
    slot (placed on first use), steps on the mesh."""

    def train_step(state: TrainState, batch):
        if not isinstance(state.params, PlacedModule):
            rules = active_rules()
            if rules is not None and rules.mesh.size > 1:
                state = place_train_state(state, rules)
        with full_fp32_matmul():
            if microbatches == 1:
                loss, metrics, grads = value_and_grad(model, state.params,
                                                      batch)
            else:
                grads, lsum = {}, 0.0
                for mb in _split_microbatches(batch, microbatches):
                    loss, _, grads = value_and_grad(model, state.params, mb,
                                                    grads)
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
