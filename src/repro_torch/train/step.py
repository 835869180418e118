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
  and data), one row group per data row;
- ``execution`` says how a row computes.  "tensor-parallel" (the dense
  attention-only decoders on a model axis of more than one slot): the
  row's model slots split its heads, MLP columns and vocab rows
  (``models.transformer.SlotParams``), each slot computing with its
  block of each leaf gathered over the data axis only (a view where its
  device holds the leaf whole), the row-parallel products summed over
  the slots in float32.  "expert-parallel" (the same decoders with
  experts): the slots split heads and vocab as above and the experts by
  blocks, and the rows step together, one forward and one backward
  through the whole mesh (``models.transformer.mesh_loss``): routing,
  capacity and the aux are the whole batch's, as on one device, and
  slot (j, m) computes experts block m of capacity block j.
  "row-gather" (RG-LRU, RWKV6, the encoder-decoder, or a model axis of
  one slot): the row computes on its first slot with the whole
  parameters (``PlacedModule.module_on``: the placed leaves themselves
  where that device holds them whole), so the model axis places storage
  only;
- the loss is a token mean over the whole batch: each row's masked mean
  is weighted by its token count over the batch's count (never a mean
  of the rows' means: with padding those differ), and so is its
  gradient;
- a config with experts that gathers rows (a model axis of one slot)
  runs its whole batch as one row group: its rows could not share the
  batch's capacity and aux, so the data axis places its storage only;
- the rows' float32 gradients are summed on the first row's slots:
  row-gather's whole leaves on its first slot, tensor-parallel's block m
  of a leaf on slot (0, m)'s device (one float32 tensor where those
  slots share a device, else a ``PlacedTensor`` of the blocks), a leaf
  replicated over the model axis taking its slots' contributions
  summed; each piece of the state is updated in place with its slice;
- microbatches split the global batch as on one device, and each
  microbatch splits over the rows.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.index import full_fp32_matmul
from ..distributed.sharding import (NamedSharding, Piece, PlacedModule,
                                    PlacedTensor, ShardingRules,
                                    active_rules, add_region_,
                                    infer_param_shardings, place_module,
                                    place_tree)
from ..kernels import counting
from ..models import transformer


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


def execution(model, rules: ShardingRules) -> str:
    """How a train step of ``model`` computes a data row on ``rules``'
    mesh: "tensor-parallel" (the dense attention-only decoders on a
    model axis of more than one slot: the row's model slots split its
    compute), "expert-parallel" (the same decoders with experts: the
    row's slots split heads, vocab and experts, and the rows step
    together, the capacity and aux the whole batch's) or "row-gather"
    (the row's first slot computes with the whole parameters)."""
    if rules is not None and rules.mesh.shape.get("model", 1) > 1 \
            and transformer.splits_over_model(model.cfg):
        return "expert-parallel" if transformer.splits_experts(model.cfg) \
            else "tensor-parallel"
    return "row-gather"


def row_slots(model, rules: ShardingRules, batch) -> list:
    """[(the devices of a data row's slots, in model order, rows)] of the
    step on ``rules.mesh``: the batch's dim 0 split over the "batch"
    axes where they divide it (else one group on the first row, as the
    reference's fallback replicates).  One group for a config with
    experts that gathers rows: its rows could not share the batch's
    capacity and aux."""
    mesh = rules.mesh
    b = torch.as_tensor(batch["labels"]).shape[0]
    axes = None if model.cfg.n_experts and \
        execution(model, rules) != "expert-parallel" else \
        rules.spec_for_shape((b,), ("batch",))[0]
    axes = () if axes is None else \
        (axes,) if isinstance(axes, str) else tuple(axes)
    n = rules.axis_size(axes) if axes else 1
    devs: dict = {}
    for c in mesh.coords():
        pos = dict(zip(mesh.axis_names, c))
        if any(pos[a] for a in mesh.axis_names
               if a not in axes and a != "model"):
            continue
        j = 0
        for a in axes:
            j = j * mesh.shape[a] + pos[a]
        devs.setdefault(j, []).append(mesh.device_at(c))
    return [(tuple(devs[j]), slice(j * (b // n), (j + 1) * (b // n)))
            for j in range(n)]


def row_groups(model, rules: ShardingRules, batch) -> list:
    """[(device, rows)]: ``row_slots`` with each group on the device of
    the first slot of its data row."""
    return [(devs[0], rows) for devs, rows in row_slots(model, rules,
                                                         batch)]


def _tokens(batch, rows) -> int:
    return int((torch.as_tensor(batch["labels"])[rows] >= 0).sum())


def _rows_of(name: str, x, rows: slice, dev) -> torch.Tensor:
    """Rows ``rows`` of one batch leaf on ``dev``: dim 0, or dim 1 of
    M-RoPE's [3, B, S] position streams."""
    x = torch.as_tensor(x)
    if name == "positions" and x.dim() == 3:
        return x[:, rows].to(dev)
    return x[rows].to(dev)


def _slot_params(cfg, plan, placed: PlacedModule, devs,
                 base: int = 0) -> tuple:
    """(``SlotParams`` of one data row's slots ``devs``, its slot 0
    numbered ``base`` over the mesh, [(leaf name, slot, the tensor the
    slot computes with, its part of the leaf)]): each slot's part a view
    where its device holds the leaf whole, else a copy gathered from the
    pieces (its own leaf for the gradient)."""
    flat, inputs = [{} for _ in devs], []
    for name, leaf in placed.leaves.items():
        for m, dev in enumerate(devs):
            part = transformer.slot_slices(plan, cfg, name, leaf.shape, m)
            if part is None:
                continue
            whole = leaf.whole_on(dev)
            t = whole[part] if whole is not None else \
                leaf.region(part, dev).detach().requires_grad_(True)
            flat[m][name] = t
            inputs.append((name, m, t, part))
    return transformer.SlotParams(cfg, plan, devs, flat, base), inputs


def _one_place(firsts: tuple) -> bool:
    """Whether row 0's slots share one device.  Under a cost counter
    each slot is a place of its own, as on a mesh of one device per slot
    (``models.transformer.SlotParams``)."""
    return len(set(firsts)) == 1 and not counting.active()


def _grad_blocks(leaf: PlacedTensor, firsts: tuple):
    """Float32 zeros for a leaf's gradient: block m of its model dim on
    ``firsts[m]`` (slot (0, m)'s device), as one tensor where those
    devices are one place (or the leaf is replicated over the model
    axis: then on ``firsts[0]``)."""
    f32, dim = torch.float32, leaf.model_dim
    if dim is None or _one_place(firsts):
        return torch.zeros(leaf.shape, dtype=f32, device=firsts[0])
    k = leaf.shape[dim] // len(firsts)
    pieces = []
    for m, dev in enumerate(firsts):
        sl = [slice(0, n) for n in leaf.shape]
        sl[dim] = slice(m * k, (m + 1) * k)
        with counting.slot(m):
            pieces.append(Piece(dev, tuple(sl), torch.zeros(
                tuple(s.stop - s.start for s in sl), dtype=f32,
                device=dev)))
    spec = tuple("model" if i == dim else None
                 for i in range(len(leaf.shape)))
    return PlacedTensor(NamedSharding(leaf.sharding.mesh, spec,
                                      leaf.sharding.rules),
                        leaf.shape, f32, tuple(pieces))


def _row_weights(batch, rows) -> list:
    """Each row's share of the batch's tokens (1.0 for one row; on the
    meta device, a trace with no labels to count, its share of the
    sequences)."""
    if len(rows) == 1:
        return [1.0]
    if torch.as_tensor(batch["labels"]).is_meta:
        counts = [r.stop - r.start for _, r in rows]
    else:
        counts = [_tokens(batch, r) for _, r in rows]
    total = max(sum(counts), 1)
    return [c / total for c in counts]


def _sum_grads(params: PlacedModule, firsts: tuple, inputs: list, loss,
               acc: dict) -> None:
    """The gradients of ``loss`` with respect to the slots' parts
    (``inputs`` of ``_slot_params``), summed into ``acc``: block m of a
    leaf split over the model axis on slot (0, m)'s device, a leaf
    replicated over it on slot (0, 0)'s."""
    # one backward thread: a remat group spans the row's devices, and
    # two devices' threads must not recompute one group at once
    with torch.autograd.set_multithreading_enabled(False):
        grads = list(torch.autograd.grad(
            loss, [t for _, _, t, _ in inputs], allow_unused=True))
    for i, (name, m, _, sl) in enumerate(inputs):
        g = grads[i]
        grads[i] = None            # free each gradient as it is summed
        if g is None:              # a norm of a slot that shares its device
            continue
        leaf = params.leaves[name]
        with counting.slot(0 if leaf.model_dim is None else m):
            if name in acc:
                add_region_(acc[name], g, sl)
            elif sl == tuple(slice(0, n) for n in leaf.shape) and (
                    leaf.model_dim is None or _one_place(firsts)):
                acc[name] = g.to(device=firsts[0], dtype=torch.float32)
            else:
                acc[name] = _grad_blocks(leaf, firsts)
                add_region_(acc[name], g, sl)
        del g


def _slot_plan(cfg, params: PlacedModule, n_slots: int):
    return transformer.slot_plan(cfg, n_slots, {
        name: leaf.model_dim for name, leaf in params.leaves.items()})


def _slot_value_and_grad(model, params: PlacedModule, batch, acc):
    """``value_and_grad`` of the tensor-parallel execution: each data row
    over its model slots (``models.transformer.SlotParams``)."""
    cfg = model.cfg
    rows = row_slots(model, params.rules, batch)
    firsts = rows[0][0]
    plan = _slot_plan(cfg, params, len(firsts))
    home = firsts[0]
    loss, ce = 0.0, 0.0
    for (devs, r), w in zip(rows, _row_weights(batch, rows)):
        part = {k: _rows_of(k, v, r, devs[0]) for k, v in batch.items()}
        slots, inputs = _slot_params(cfg, plan, params, devs)
        part_loss, metrics = model.loss(slots, part)
        _sum_grads(params, firsts, inputs,
                   part_loss if w == 1.0 else part_loss * w, acc)
        loss = loss + w * part_loss.detach().to(home)
        ce = ce + w * metrics["ce"].detach().to(home)
    return loss, {"ce": ce, "aux": 0.0}, acc


def _expert_value_and_grad(model, params: PlacedModule, batch, acc):
    """``value_and_grad`` of the expert-parallel execution: every data
    row over its model slots at once (``models.transformer.mesh_loss``),
    one backward pass through the whole mesh."""
    cfg = model.cfg
    rows = row_slots(model, params.rules, batch)
    firsts = rows[0][0]
    plan = _slot_plan(cfg, params, len(firsts))
    sps, inputs, parts = [], [], []
    for j, (devs, r) in enumerate(rows):
        parts.append({k: _rows_of(k, v, r, devs[0])
                      for k, v in batch.items()})
        sp, ins = _slot_params(cfg, plan, params, devs, j * len(devs))
        sps.append(sp)
        inputs.extend(ins)
    loss, metrics = transformer.mesh_loss(sps, cfg, parts,
                                          _row_weights(batch, rows))
    _sum_grads(params, firsts, inputs, loss, acc)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, acc


def value_and_grad(model, params, batch, acc=None):
    """(loss, metrics, {name: float32 gradient}) of ``model.loss`` over
    the whole batch, the gradients summed into ``acc`` when given.  A
    module is one group on its own device; a ``PlacedModule`` computes
    per row group of its rules' mesh (``execution``), each row's masked
    token mean weighted by its share of the batch's tokens, summed on the
    first row."""
    how = execution(model, params.rules) \
        if isinstance(params, PlacedModule) else "row-gather"
    if how == "tensor-parallel":
        return _slot_value_and_grad(model, params, batch,
                                    {} if acc is None else acc)
    if how == "expert-parallel":
        return _expert_value_and_grad(model, params, batch,
                                      {} if acc is None else acc)
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
                    for t in ([p.tensor for p in v.pieces]
                              if isinstance(v, PlacedTensor) else [v]):
                        t.mul_(inv)
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
