"""Gradient compression for the data-parallel all-reduce.

This package's port of the JAX package's ``distributed/compression.py``
(the reference), with its semantics.  There the step is a ``shard_map``
over the mesh: each slot computes its own loss and gradient on its shard
of the batch and the gradients meet in an explicit collective; here one
process runs the slots along ``axis`` one after another (slots that share
an index along ``axis`` see the same shard and compute the same thing,
as in the reference) and reduces in the same arithmetic:

  - ``none``: the mean of the slots' float32 gradients;
  - ``bf16``: each gradient cast to bf16, the bf16 values summed and
    rounded to bf16 once (the reference's all-reduce sums them in float32
    on its CPU backend; ``tests/test_torch_compression.py`` holds the
    step-1 parameters to it element by element, which a sum in bf16 add
    by add misses), cast back and divided by the slot count (2x fewer
    wire bytes than float32);
  - ``int8_ef``: int8 quantization with error feedback (Karimireddy et
    al., 2019).  Per slot ``acc = g + err`` and a local scale
    ``max|acc| / 127``; the scale is the maximum over the slots (at
    least 1e-12: the reference's ``pmax``, so dequantization agrees on
    every slot); ``q = clip(round(acc / scale), -127, 127)`` and each
    slot keeps ``err' = acc - q * scale``; the gradient is the int32 sum
    of the q times scale over the slot count.  A scale covers one leaf of
    the reference's parameter tree, where the layers of a pattern group
    are stacked into one leaf: here the unrolled layers that the
    reference stacks share one scale (``scale_groups``).

The loss is the mean of the slots' losses, each the mean over its own
shard (so is its gradient; a config with experts routes per slot).
Parameters and moments are replicated: one copy per distinct device
(``replicate``; a plain module and its moments do when every slot lies on
its device).  The errors are per slot, each on its slot's device.

Wire bytes per slot and step, at each scheme's width: 4, 2 and 1 per
parameter (the reference's ``int8_ef`` sums its int8 values as int32).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.index import full_fp32_matmul
from ..launch.mesh import Mesh
from .sharding import PlacedModule, ShardingRules, place_module, place_tree

SCHEMES = ("bf16", "int8_ef", "none")
#: Bytes a scheme puts on a wire per parameter and slot.
WIRE_BYTES = {"none": 4, "bf16": 2, "int8_ef": 1}


def replicate(tree, mesh: Mesh):
    """A module (``PlacedModule``) or {name: tensor} (moments) replicated
    on ``mesh``: one whole copy per distinct device, the tree itself where
    it lies there already."""
    rules = ShardingRules(mesh=mesh, rules={})
    if isinstance(tree, (nn.Module, PlacedModule)):
        return place_module(tree, rules, {
            k: (None,) * p.dim() for k, p in tree.named_parameters()})
    return place_tree(tree, rules, {k: (None,) * v.dim()
                                    for k, v in tree.items()})


def _slot_devices(mesh: Mesh, axis: str) -> list:
    """The device of each index along ``axis``: its first slot's."""
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                         f"{mesh.axis_names}")
    k = mesh.axis_names.index(axis)
    devs: dict = {}
    for c in mesh.coords():
        devs.setdefault(c[k], mesh.device_at(c))
    return [devs[i] for i in range(mesh.shape[axis])]


def _slot_scales(local: list) -> list:
    """Each slot's dequantization scale from the slots' local scales: the
    consensus, the maximum over slots (at least 1e-12), on every slot."""
    home = local[0].device
    scale = torch.stack([torch.clamp(s.to(home), min=1e-12)
                         for s in local]).amax()
    return [scale] * len(local)


def scale_groups(cfg, names) -> dict:
    """{group: [parameter names]} of the int8 scales: the parameters that
    the reference stacks into one leaf (``layers.{g * P + i}.x`` for the
    P layers of the pattern and g < n_groups, ``groups/l{i}/x`` there;
    each side's layers of the encoder-decoder) share a group; any other
    parameter is a group of its own."""
    out: dict = {}
    stacked = cfg.n_groups * len(cfg.pattern)
    for name in names:
        key = name
        parts = name.split(".")
        if cfg.family == "encdec" and len(parts) > 2 \
                and parts[1] == "layers":
            key = ".".join(parts[:2] + parts[3:])
        elif cfg.family != "encdec" and parts[0] == "layers" \
                and int(parts[1]) < stacked:
            key = ".".join(["groups", f"l{int(parts[1]) % len(cfg.pattern)}"]
                           + parts[2:])
        out.setdefault(key, []).append(name)
    return out


def _module_on(params, dev: torch.device) -> nn.Module:
    if isinstance(params, PlacedModule):
        return params.module_on(dev)
    if params.device != dev:
        raise ValueError(
            f"a plain module on {params.device} cannot serve a slot on "
            f"{dev}; pass compression.replicate(params, mesh) (and its "
            "moments)")
    return params


def make_compressed_train_step(model, optimizer, mesh: Mesh, *,
                               axis: str = "data",
                               scheme: str = "int8_ef") -> tuple:
    """DP train step with an explicit, compressed gradient reduction.

    Parameters and moments replicated, the batch split over ``axis``.
    Returns (step_fn, init_error); the error state carries the per-slot
    residuals when ``scheme == "int8_ef"``.
    step_fn(params, opt_state, err, batch) -> (params, opt_state, err,
    loss)."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    from ..train.step import value_and_grad     # deferred: import cycle

    devs = _slot_devices(mesh, axis)
    n = len(devs)
    home = devs[0]
    groups: dict = {}

    def shards(batch) -> list:
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{n} slots of axis {axis!r}")
        per = b // n
        return [{k: torch.as_tensor(v)[i * per:(i + 1) * per].to(dev)
                 for k, v in batch.items()} for i, dev in enumerate(devs)]

    def slot_grads(params, batch):
        """Yields (slot, loss, {name: float32 gradient}) slot by slot."""
        for i, (dev, part) in enumerate(zip(devs, shards(batch))):
            with full_fp32_matmul():
                loss, _, grads = value_and_grad(model, _module_on(params,
                                                                  dev), part)
            yield i, loss, grads

    def step_fn(params, opt_state, err, batch):
        if not groups:
            groups.update(scale_groups(model.cfg, [
                k for k, _ in params.named_parameters()]))
        losses = []
        grads = {}
        if scheme == "int8_ef":
            local = {}
            for i, loss, g in slot_grads(params, batch):
                losses.append(loss)
                for k in list(g):
                    acc = err[i][k]
                    acc.add_(g.pop(k).to(acc.device))   # err[i] holds acc
                for names in groups.values():
                    local.setdefault(names[0], []).append(torch.stack([
                        err[i][k].abs().amax() for k in names]).amax()
                        / 127.0)
            for names in groups.values():
                scales = _slot_scales(local[names[0]])
                for k in names:
                    total = None
                    for i in range(n):
                        acc = err[i][k]
                        sc = scales[i].to(acc.device)
                        q = torch.clamp(torch.round(acc / sc), -127, 127)
                        acc.sub_(q * sc)                # err' = acc - q scale
                        qi = q.to(device=home, dtype=torch.int32)
                        total = qi if total is None else total.add_(qi)
                        del q
                    grads[k] = total.to(torch.float32) * scales[0] / float(n)
        else:
            for i, loss, g in slot_grads(params, batch):
                losses.append(loss)
                for k in list(g):
                    v = g.pop(k).to(home)
                    if scheme == "bf16":
                        v = v.to(torch.bfloat16).to(torch.float32)
                    grads[k] = v if k not in grads else grads[k].add_(v)
            for k, v in grads.items():
                if scheme == "bf16":
                    v = v.to(torch.bfloat16)
                grads[k] = v.to(torch.float32) / float(n)
        loss = sum(l.to(home) for l in losses) / float(n)
        params, opt_state, _ = optimizer.update(grads, opt_state, params)
        return params, opt_state, err, loss

    def init_error(params):
        names = [(k, p) for k, p in params.named_parameters()]
        if scheme != "int8_ef":
            return {k: torch.zeros((), dtype=torch.float32) for k, _ in names}
        return [{k: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                device=dev) for k, p in names}
                for dev in devs]

    return step_fn, init_error
