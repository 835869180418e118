"""The dry-run: every (arch x shape x mesh) cell costed with no device.

This package's port of the JAX package's ``launch/dryrun.py``.  The
reference lowers and compiles each cell's step on 512 forced host
devices and reads XLA's memory and cost analyses and the collectives of
the optimized HLO.  PyTorch has no SPMD compiler to read those from, so
the port traces its own step on meta tensors (shapes and dtypes, no
bytes) and costs it against H100 peaks:

- **The trace.**  ``specs.build_cell``'s step runs under ``StepCounter``
  (a ``TorchDispatchMode``) on the busiest device's share of the batch:
  one data row's rows, as
  ``train.step.row_groups`` splits a batch over the production mesh's
  "batch" axes (the whole batch where they do not divide it, and for a
  config with experts that gathers rows).  A train cell whose step is
  tensor-parallel (``train.step.execution``: the five dense
  attention-only decoders) traces that row over the mesh's model slots,
  all on the meta device, and the counter keeps each slot's share apart.
  An expert-parallel train cell (qwen3-moe-30b-a3b, dbrx-132b) traces
  every row over its slots, since each MoE layer couples the rows; the
  meta device has no routing, so the all-to-all's moves are sized by the
  most even routing the counts allow (``models.ffn.even_counts``); the
  slabs' shapes, and so the FLOPs, do not depend on routing.  The step is the one
  the port runs, attention's
  key chunk included, but for RWKV6: its time-mix is traced in the
  chunked form (``lowering.unrolled(attn_chunks=None, wkv_chunks=8)``),
  since the time loop the port runs takes ~20 minutes a cell to trace;
  such a record says so (``wkv_chunked``).  The counter records

  - matmul FLOPs by input dtype, by ``torch.utils.flop_counter``'s
    formulas; a kernel's operations under its name (the kernel wrappers'
    meta branches report to the counter: ``kernels.counting``);
  - HBM bytes: the input plus output bytes of each non-view aten op on a
    device (an expanded dim counts once; ``empty`` moves none; a gather
    reads from its source only the elements it writes, an in-place
    scatter writes into its target only as many elements as its values
    argument holds) and each kernel call's bytes.  Eager
    PyTorch fuses nothing, so this is what the step moves, ignoring
    cache reuse;
  - the peak of live bytes of the tensors the step makes (weakref
    finalizers on their storages), by region: "forward", "backward"
    (ops the autograd engine runs, remat's recomputation included),
    "reduce" (after the backward pass, grad mode on: the float32
    gradient casts) and "update" (after it, grad mode off: AdamW);
  - the aten op calls on a device (host scalars are not counted).

- **The mesh** (``reckon``), from the specs and from how the port runs a
  mesh (``train/step.py``, ``sharding.place`` / ``leaf_pieces`` /
  ``PlacedTensor.gather``).  On a production mesh every device is one
  slot and holds one block of each leaf (the whole leaf where its spec
  is replicated).  The record's ``execution`` says which of two the cell
  runs.  Tensor-parallel train cells (``reckon_slots``): device (j, m)
  computes slot m's traced share of row j, gathers its parts of the
  leaves over the data axis only ("param_gather"), all-reduces the
  row-parallel partial sums and the embedding with the row's other slots
  and sends slot 0 its loss terms, the gradients moving back
  ("model_sum", the moves the trace counted), sends its gradient
  parts (the parameters' dtype) to slot (0, m), where block m of a leaf
  is summed in float32 (slot (0, 0) for a leaf replicated over the
  model axis; "grad_reduce"), and gets its pieces' float32 slices back
  ("grad_scatter").  Expert-parallel cells the same, each device
  (j, m) its own traced share, plus the moves between rows: a row's
  tokens to the owners of its pairs' cells and their outputs back, the
  counts' scan and the aux's sums ("all_to_all"); ``expert_flops`` is
  the forward expert products' FLOPs, the busiest device's and the
  mesh's.  Every other cell (serving, and the families that
  gather rows) is row-gather: each data row computes on its first slot
  (flat index j * model) with the whole parameters gathered there; the
  model axis shards storage only.  Per device, with N devices, R row
  devices, p = a leaf's bytes / its block count, W = the bytes of the
  leaves that are split:

  - state: Σ p over parameters and both float32 moments, and over the
    batch or caches (``specs.cell_in_shardings``);
  - param_gather: ``gather`` copies every piece, replicas included, so a
    row device receives (N - 1) Σ p and holds W more; each device sends
    its pieces to every other row device;
  - grad_reduce (train, R > 1): each other row device sends its
    gradients (the parameters' dtype, Σ leaf bytes) to row 0's first
    slot, which adds them into its float32 sums: (R - 1) Σ numel
    (2 b + 8) more HBM bytes there, b the parameters' bytes per element;
  - grad_scatter (train): that slot sends every other device its pieces'
    float32 slices (Σ numel 4 / blocks each);
  - cache_gather / cache_writeback (serving): a row device fetches the
    blocks of its rows of each cache leaf it does not hold (each block
    once, from a device on its host where one holds it) and sends each
    leaf the step replaced back to every device that holds a block of
    its rows (the reference's SPMD step keeps caches in place; the
    port serves on one device and has no mesh path of its own);
  - HBM: the row's traced bytes on row devices (the traced "reduce"
    bytes on row 0's slot only), the update's bytes times the device's
    share of the state's elements, and each byte sent read once and each
    byte received written once;
  - links: NVLink at 450 GB/s each way inside a host of 8 devices
    (row-major device order), 50 GB/s each way per device between hosts
    (the DGX H100's 400 Gb/s NIC per GPU: an assumption, not measured).
    A device's collective time is the largest of its four directions'
    bytes over their rate.

- **Roofline** at one H100 SXM's published peaks (700 W): FLOPs by dtype
  over 989 TFLOP/s (bf16), 67 TFLOP/s (float32: the port's products run
  with TF32 off) or 1,979 TOP/s (int8); a kernel's operations over the
  67 T/s of the CUDA cores (as ``chip_smoke.py``'s bounds); HBM bytes
  over 3.35 TB/s.  The busiest device is the one whose largest term is
  largest; its three terms and the bound are reported.  The reference's
  TPU peaks are not carried over.

The reference's HLO collective kinds (all-gather, all-reduce, ...) do not
apply: ``collective_bytes`` is the reckoning above, by kind, of the bytes
the busiest device sends and receives.

Results stream into ``results/dryrun/<cell>.json``, so an interrupted
sweep resumes where it stopped.  ``main`` costs each cell by
``run_cell_extrapolated``: the meta device runs ~50-100 us per op, and a
full-depth trace of qwen3-moe's train step (48 layers, its whole batch
one row group) takes ~20 minutes, while every count is affine in depth.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, get_config, list_archs
from ..distributed import sharding as shd
from ..kernels import counting
from ..models import get_model, lowering, transformer
from ..train.step import execution, row_groups
from . import specs
from .mesh import make_host_mesh, make_production_mesh

# One H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "int8": 1979e12, "float8_e4m3fn": 1979e12,
              "float8_e5m2": 1979e12}
KERNEL_OPS_PER_S = 67e12      # the scan kernels' integer ops, CUDA cores
HBM_BW = 3.35e12              # bytes/s
HBM_CAPACITY = 80e9           # bytes
NVLINK_BW = 450e9             # bytes/s each way, inside a host
NIC_BW = 50e9                 # bytes/s each way per device, across hosts
DEVICES_PER_HOST = 8

_NO_BYTES = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default}
_REGIONS = ("forward", "backward", "reduce", "update")
#: Ops that read from their source (the first input) only the elements
#: they write out.
_GATHERS = {torch.ops.aten.index.Tensor, torch.ops.aten.gather.default,
            torch.ops.aten.index_select.default,
            torch.ops.aten.embedding.default}
#: In-place scatters, which write into their target (the first input) as
#: many elements as the argument at this position holds: the values (a
#: scalar's scatter writes one per index).
_SCATTERS = {torch.ops.aten.index_put_.default: 2,
             torch.ops.aten.scatter_.src: 3, torch.ops.aten.scatter_.value: 2,
             torch.ops.aten.scatter_add_.default: 3,
             torch.ops.aten.index_add_.default: 3}
#: The device whose ops are host bookkeeping (a schedule's scalars).
_HOST = "cpu"


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` reads or writes: an expanded (stride
    0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _op_bytes(func, args, ins, outs) -> int:
    """The HBM bytes of one op: its inputs read once and its outputs
    written once, but a gather reads from its source only what it writes,
    and an in-place scatter writes into its target only as many elements
    as its values hold."""
    if func in _GATHERS:
        src = args[0]
        return sum(_distinct_bytes(t) for t in ins if t is not src) \
            + 2 * sum(_distinct_bytes(t) for t in outs)
    if func in _SCATTERS:
        target, values = args[0], args[_SCATTERS[func]]
        written = _distinct_bytes(values) // values.element_size() \
            * target.element_size()
        return sum(_distinct_bytes(t) for t in ins if t is not target) \
            + written
    return sum(_distinct_bytes(t) for t in ins + outs)


class _SlotTagger(TorchFunctionMode):
    """Marks the autograd nodes each call inside a ``counting.slot``
    block made (its outputs' nodes and, back to the nodes marked before,
    those of the ops inside it) with that slot, so that the counter
    attributes their backward to it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        open_, m = counting.current_slot()
        if open_:
            todo = [t.grad_fn for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            while todo:
                node = todo.pop()
                if node is None or "slot" in node.metadata:
                    continue
                node.metadata["slot"] = m
                todo.extend(n for n, _ in node.next_functions)
        return out


class StepCounter(TorchDispatchMode):
    """Counts what a step dispatches (see the module's docstring); also
    the cost counter of the kernel wrappers while it is entered.  An op
    whose tensors all lie on the CPU is host bookkeeping (a schedule's
    scalars) and is not counted.

    A tensor- or expert-parallel step's ops are also counted per slot
    (``slot_flops``, ``slot_bytes``, ``slot_peak``; the key None is the
    row's home work): forward ops by the open ``counting.slot`` block,
    backward ops by the slot the executing autograd node was marked
    with.  ``moves`` counts the bytes the step moves between slots, by
    (kind, source slot, destination slot); ``part_flops`` the forward
    FLOPs of each ``counting.part`` by slot (the expert products:
    "experts")."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype = collections.Counter()
        self.ops = collections.Counter()
        self.bytes = collections.Counter()
        self.kernels: dict = {}
        self.live = collections.Counter()
        self.peak = collections.Counter()
        self.slot_flops = collections.defaultdict(collections.Counter)
        self.slot_bytes = collections.defaultdict(collections.Counter)
        self.slot_live = collections.Counter()
        self.slot_peak = collections.Counter()
        self.moves = collections.Counter()
        self.part_flops = collections.defaultdict(collections.Counter)
        self._tracked: dict = {}
        self._backward_seen = False
        self._costs: list = []

    def __enter__(self):
        # re-entered while it dispatches (``decompose``): one per entry
        self._costs.append((counting.cost_counter(self), _SlotTagger()))
        for c in self._costs[-1]:
            c.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for c in reversed(self._costs.pop()):
                c.__exit__(*exc)

    def _region(self) -> str:
        if torch._C._current_graph_task_id() != -1:
            self._backward_seen = True
            return "backward"
        if not self._backward_seen:
            return "forward"
        return "reduce" if torch.is_grad_enabled() else "update"

    @staticmethod
    def _slot():
        """The model slot the op in flight works for (None: home)."""
        open_, m = counting.current_slot()
        if open_:
            return m
        node = torch._C._current_autograd_node()
        return None if node is None else node.metadata.get("slot")

    def kernel_call(self, name: str, nbytes: int, ops: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["ops"] += ops
        region, m = self._region(), self._slot()
        self.bytes[region] += nbytes
        self.flops_by_dtype[name] += ops
        self.slot_bytes[m][region] += nbytes
        self.slot_flops[m][name] += ops

    def slot_move(self, src: int, dst: int, nbytes: int,
                  kind: str = "model_sum") -> None:
        self.moves[(kind, src, dst)] += nbytes

    def _track(self, t: torch.Tensor, region: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._tracked:
            return
        nb, m = st.nbytes(), self._slot()
        self._tracked[key] = (nb, region, m)
        for r in (region, "total"):
            self.live[r] += nb
            self.peak[r] = max(self.peak[r], self.live[r])
        self.slot_live[m] += nb
        self.slot_peak[m] = max(self.slot_peak[m], self.slot_live[m])
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        nb, region, m = self._tracked.pop(key)
        self.live[region] -= nb
        self.live["total"] -= nb
        self.slot_live[m] -= nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:          # as FlopCounterMode: count what it becomes
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if all(t.device.type == _HOST for t in ins + outs):
            return out              # host bookkeeping, not device work
        region, m = self._region(), self._slot()
        self.ops[str(func)] += 1
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = str(ins[0].dtype).split(".")[-1]
            self.flops_by_dtype[dtype] += n
            self.slot_flops[m][dtype] += n
            part = counting.current_part()
            if part is not None and region == "forward":
                self.part_flops[m][part] += n
        if func.is_view or func in _NO_BYTES:
            return out
        nbytes = _op_bytes(func, args, ins, outs)
        self.bytes[region] += nbytes
        self.slot_bytes[m][region] += nbytes
        if not func._schema.is_mutable:
            for t in outs:
                if t.device.type != _HOST:
                    self._track(t, region)
        return out

    @property
    def matmul_flops(self) -> int:
        return sum(v for k, v in self.flops_by_dtype.items()
                   if k not in self.kernels)


def roofline(flops_by_dtype: dict, hbm_bytes: float,
             link_bytes: dict) -> dict:
    """Least seconds of one device's step by each term: Σ FLOPs of a
    dtype over its peak (a kernel's operations, under its name, over
    ``KERNEL_OPS_PER_S``; a dtype with no listed peak at the float32
    rate), HBM bytes over ``HBM_BW``, and the slowest link direction
    (``link_bytes``: nvlink_in / nvlink_out over ``NVLINK_BW``, nic_in /
    nic_out over ``NIC_BW``).  The bottleneck is the largest."""
    t_compute = sum(v / _peak(k) for k, v in flops_by_dtype.items())
    t_memory = hbm_bytes / HBM_BW
    t_coll = max(link_bytes.get("nvlink_in", 0) / NVLINK_BW,
                 link_bytes.get("nvlink_out", 0) / NVLINK_BW,
                 link_bytes.get("nic_in", 0) / NIC_BW,
                 link_bytes.get("nic_out", 0) / NIC_BW)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    total = terms[dom]
    terms["bottleneck"] = dom
    terms["compute_fraction"] = t_compute / total if total > 0 else 0.0
    return terms


def _peak(key: str) -> float:
    if key in PEAK_FLOPS:
        return PEAK_FLOPS[key]
    if isinstance(getattr(torch, key, None), torch.dtype):
        return PEAK_FLOPS["float32"]
    return KERNEL_OPS_PER_S                  # a kernel's name


# ---------------------------------------------------------------------------
# The mesh reckoning
# ---------------------------------------------------------------------------


def _host(i: int) -> int:
    return i // DEVICES_PER_HOST


class _Links:
    """Per device and kind, the bytes sent and received over NVLink
    (same host) or the NIC (another host)."""

    def __init__(self, n: int):
        self.dirs = {k: [0.0] * n for k in
                     ("nvlink_in", "nvlink_out", "nic_in", "nic_out")}
        self.kinds: dict = collections.defaultdict(lambda: [0.0] * n)

    def move(self, kind: str, src: int, dst: int, nbytes: float) -> None:
        if src == dst or nbytes == 0:
            return
        link = "nvlink" if _host(src) == _host(dst) else "nic"
        self.dirs[link + "_out"][src] += nbytes
        self.dirs[link + "_in"][dst] += nbytes
        self.kinds[kind][src] += nbytes
        self.kinds[kind][dst] += nbytes

    def sent(self, i: int) -> float:
        return self.dirs["nvlink_out"][i] + self.dirs["nic_out"][i]

    def received(self, i: int) -> float:
        return self.dirs["nvlink_in"][i] + self.dirs["nic_in"][i]


def _leaf_bytes(t) -> int:
    return t.numel() * t.element_size()


def _cache_leaves(tree) -> list:
    out = []
    specs.map_cache(lambda name, leaf: out.append((name, leaf)) or leaf,
                    tree)
    return out


def _holders(mesh, spec) -> dict:
    """{block index: the slots holding it, row-major}."""
    out: dict = collections.defaultdict(list)
    for i, c in enumerate(mesh.coords()):
        out[shd._slot_block(mesh, spec, c)].append(i)
    return out


def _fetch_rows(links, kind, mesh, spec, shape, itemsize, holders, rows,
                dst, back=False) -> float:
    """The blocks of ``shape`` (placed by ``spec``) that overlap dim-0
    ``rows``: to ``dst`` each once from a holder (one on its host where
    there is one), or with ``back`` from ``dst`` to every holder.
    Returns the bytes of those rows."""
    nbytes = math.prod(shape) * itemsize / shd._n_blocks(mesh, spec)
    got = 0.0
    for b, devs in holders.items():
        sl = shd._block_slices(mesh, spec, shape, b)[0]
        overlap = max(0, min(sl.stop, rows.stop) - max(sl.start,
                                                       rows.start))
        part = nbytes * overlap / max(sl.stop - sl.start, 1)
        if part == 0:
            continue
        if back:
            for i in devs:
                links.move(kind, dst, i, part)
        elif dst not in devs:
            near = [i for i in devs if _host(i) == _host(dst)]
            links.move(kind, (near or devs)[0], dst, part)
        got += part
    return got


def reckon(kind: str, inputs, shardings, rules, n_rows: int, rows: slice,
           replaced: set, counter: StepCounter) -> dict:
    """Per device of ``rules.mesh``: state, links, HBM, FLOPs and peak,
    from the traced row (``counter``), the inputs' specs and the port's
    row-gather execution (the module's docstring).  ``replaced``: ids of
    the input cache leaves the step returned anew."""
    mesh = rules.mesh
    n = mesh.size
    row_devs = [j * (n // n_rows) for j in range(n_rows)] if n_rows > 1 \
        else [0]
    home = row_devs[0]
    links = _Links(n)

    params = inputs[0].params if kind == "train" else inputs[0]
    p_sh = shardings[0].params if kind == "train" else shardings[0]
    state = {"params": 0.0, "moments": 0.0, "inputs": 0.0}
    gathered = gather_piece = 0.0
    grad_bytes = 0.0
    add_bytes = 0.0
    for name, leaf in params.named_parameters():
        spec = p_sh[name].spec
        nb = shd._n_blocks(mesh, spec)
        size = _leaf_bytes(leaf)
        state["params"] += size / nb
        if kind == "train":
            state["moments"] += 2 * leaf.numel() * 4 / nb
            grad_bytes += size
            add_bytes += leaf.numel() * (2 * leaf.element_size() + 8)
        if nb > 1:                  # every piece copied, replicas too
            gathered += size
            gather_piece += size / nb
    for r in row_devs:
        for i in range(n):
            links.move("param_gather", i, r, gather_piece)
    if kind == "train" and n_rows > 1:
        for r in row_devs[1:]:
            links.move("grad_reduce", r, home, grad_bytes)
    state_share = 1.0
    if kind == "train":
        f32_piece = sum(p.numel() * 4 / shd._n_blocks(mesh, p_sh[k].spec)
                        for k, p in params.named_parameters())
        for i in range(n):
            links.move("grad_scatter", home, i, f32_piece)
        state_share = (state["params"] + state["moments"]) / max(
            1.0, sum(_leaf_bytes(p) + 8 * p.numel()
                     for _, p in params.named_parameters()))
        for name, leaf in inputs[1].items():
            nb = shd._n_blocks(mesh, shardings[1][name].spec)
            state["inputs"] += _leaf_bytes(leaf) / nb
    else:
        for x, xs in zip(inputs[1:], shardings[1:]):
            if torch.is_tensor(x):
                state["inputs"] += _leaf_bytes(x) / shd._n_blocks(
                    mesh, xs.spec)
                continue
            for (name, leaf), (_, sh) in zip(_cache_leaves(x),
                                             _cache_leaves(xs)):
                shape = tuple(leaf.shape)
                state["inputs"] += _leaf_bytes(leaf) / shd._n_blocks(
                    mesh, sh.spec)
                holders = _holders(mesh, sh.spec)
                per_row = shape[0] // n_rows
                for j, r in enumerate(row_devs):
                    part = slice(j * per_row, (j + 1) * per_row)
                    args = (mesh, sh.spec, shape, leaf.element_size(),
                            holders, part, r)
                    got = _fetch_rows(links, "cache_gather", *args)
                    if r == home:
                        gathered += got
                    if id(leaf) in replaced:
                        _fetch_rows(links, "cache_writeback", *args,
                                    back=True)

    row_bytes = counter.bytes["forward"] + counter.bytes["backward"]
    flops, hbm = [], []
    for i in range(n):
        is_row = i in row_devs
        h = (row_bytes if is_row else 0.0) \
            + counter.bytes["update"] * state_share \
            + links.sent(i) + links.received(i)
        if i == home:
            h += counter.bytes["reduce"] + (n_rows - 1) * add_bytes
        flops.append(dict(counter.flops_by_dtype) if is_row else {})
        hbm.append(h)
    on_row = [i in row_devs for i in range(n)]
    experts = sum(c["experts"] for c in counter.part_flops.values())
    return _device_terms(
        n, flops, hbm, links, counter, state,
        [gathered if r else 0.0 for r in on_row],
        [float(counter.peak["total"]) if r else 0.0 for r in on_row],
        [float(counter.peak["reduce"]) if i == home else 0.0
         for i in range(n)], n_rows, rows.stop - rows.start,
        [experts if r else 0 for r in on_row])


def _device_terms(n, flops, hbm, links, counter, state, gathered, peak,
                  grads_f32, n_rows, b_row, experts) -> dict:
    """The record's numbers from per-device FLOPs ({dtype: n}), HBM
    bytes, links, bytes held (state, gathered, step peak, float32
    gradient sums) and forward expert FLOPs: the busiest device's, the
    one whose largest roofline term is largest."""
    per_dev = [roofline(flops[i], hbm[i],
                        {k: v[i] for k, v in links.dirs.items()})
               for i in range(n)]
    score = [max(r["compute_s"], r["memory_s"], r["collective_s"])
             for r in per_dev]
    busy = max(range(n), key=lambda i: (score[i], -i))
    coll = {k: v[busy] for k, v in sorted(links.kinds.items())}
    coll["total"] = sum(coll.values())
    bpd = {**state, "gathered": gathered[busy], "step_peak": peak[busy],
           "grads_f32": grads_f32[busy]}
    bpd["peak"] = sum(state.values()) + bpd["gathered"] + bpd["step_peak"]
    fl = flops[busy]
    return {"busiest_device": busy, "flops": sum(
                v for k, v in fl.items() if k not in counter.kernels),
            "flops_by_dtype": fl, "hbm_bytes": hbm[busy],
            "collective_bytes": coll,
            "link_bytes": {k: v[busy] for k, v in links.dirs.items()},
            "bytes_per_device": bpd, "roofline": per_dev[busy],
            "fits": bpd["peak"] <= HBM_CAPACITY,
            "bytes_by_region": {r: counter.bytes[r] for r in _REGIONS},
            "expert_flops": {"device": experts[busy],
                             "mesh": sum(experts)},
            "rows": n_rows, "row_batch": b_row}


def reckon_slots(inputs, shardings, rules, n_rows: int, rows: slice,
                 counter: StepCounter, cfg, all_rows: bool = False) -> dict:
    """``reckon`` of a train cell in the tensor-parallel execution (the
    module's docstring), from a trace of one data row over its model
    slots, or with ``all_rows`` in the expert-parallel execution, from a
    trace of every row (slots numbered j * model + m): per device, its
    slot's traced work, its parameter parts gathered over the data axis,
    the moves between a row's slots ("model_sum") and between rows
    ("all_to_all"), the gradient parts sent to slot (0, m) and the
    float32 slices sent back to every piece."""
    mesh = rules.mesh
    n, n_model = mesh.size, mesh.shape["model"]
    coords = mesh.coords()
    links = _Links(n)
    params, p_sh = inputs[0].params, shardings[0].params
    leaves = list(params.named_parameters())
    plan = transformer.slot_plan(cfg, n_model, {
        name: shd.spec_model_dim(p_sh[name].spec) for name, _ in leaves})
    state = {"params": 0.0, "moments": 0.0, "inputs": 0.0}
    gathered, grads_f32 = [0.0] * n, [0.0] * n
    add_hbm = [0.0] * n
    kinds: dict = collections.Counter()
    for name, leaf in leaves:
        spec = tuple(p_sh[name].spec)
        nb = shd._n_blocks(mesh, spec)
        state["params"] += _leaf_bytes(leaf) / nb
        state["moments"] += 2 * leaf.numel() * 4 / nb
        parts = tuple(transformer.slot_slices(plan, cfg, name, leaf.shape, m)
                      for m in range(n_model))
        kinds[(tuple(leaf.shape), leaf.element_size(), spec, parts)] += 1
    for name, leaf in inputs[1].items():
        state["inputs"] += _leaf_bytes(leaf) / shd._n_blocks(
            mesh, shardings[1][name].spec)
    for (shape, item, spec, parts), count in kinds.items():
        holders = _holders(mesh, spec)
        blocks = {b: shd._block_slices(mesh, spec, shape, b)
                  for b in holders}
        md = shd.spec_model_dim(spec)
        numel = math.prod(shape)
        for i in range(n):
            j, m = divmod(i, n_model)
            part = parts[m]
            if part is None or j >= n_rows:
                continue
            got = 0.0
            for b, devs in holders.items():
                if i in devs:
                    continue
                cut = shd._intersect(blocks[b], part)
                if cut is None:
                    continue
                nbytes = math.prod(x.stop - x.start for x in cut) * item
                near = [d for d in devs if _host(d) == _host(i)]
                links.move("param_gather", (near or devs)[0], i,
                           count * nbytes)
                got += nbytes
            size = math.prod(x.stop - x.start for x in part)
            if got:
                gathered[i] += count * size * item
            dst = m if md is not None else 0
            links.move("grad_reduce", i, dst, count * size * item)
            if i != dst:
                add_hbm[dst] += count * size * (2 * item + 8)
        for i, c in enumerate(coords):
            src = dict(zip(mesh.axis_names, c))["model"] \
                if md is not None else 0
            links.move("grad_scatter", src, i,
                       count * numel * 4 / shd._n_blocks(mesh, spec))
            if i < n_model and (md is not None or i == 0):
                grads_f32[i] += count * numel * 4 / (
                    n_model if md is not None else 1)
    for j in range(1 if all_rows else n_rows):
        for (kind, src, dst), nbytes in counter.moves.items():
            links.move(kind, j * n_model + src, j * n_model + dst, nbytes)
    state_share = (state["params"] + state["moments"]) / max(
        1.0, sum(_leaf_bytes(p) + 8 * p.numel() for _, p in leaves))
    flops, hbm, peak, experts = [], [], [], []
    for i in range(n):
        j, m = divmod(i, n_model)
        if all_rows:
            tags = (None, 0) if i == 0 else (i,)
        else:
            tags = (None, 0) if m == 0 else (m,)
        on_row = j < n_rows
        fl: dict = collections.Counter()
        traced = 0.0
        if on_row:
            for t in tags:
                fl.update(counter.slot_flops[t])
                traced += counter.slot_bytes[t]["forward"] \
                    + counter.slot_bytes[t]["backward"]
        h = traced + counter.bytes["update"] * state_share \
            + links.sent(i) + links.received(i) + add_hbm[i]
        if i < n_model:          # row 0 sums its own gradient parts
            h += sum(counter.slot_bytes[t]["reduce"] for t in tags)
        flops.append(dict(fl))
        hbm.append(h)
        peak.append(float(sum(counter.slot_peak[t] for t in tags))
                    if on_row else 0.0)
        experts.append(sum(counter.part_flops[t]["experts"] for t in tags)
                       if on_row else 0)
    return _device_terms(n, flops, hbm, links, counter, state, gathered,
                         peak, grads_f32, n_rows, rows.stop - rows.start,
                         experts)


def _execution(kind: str, n_rows: int, b_row: int,
               n_model: int = 1, how: str = "row-gather") -> str:
    if how == "expert-parallel":
        return (f"expert-parallel: each of {n_rows} data row(s) computes "
                f"its {b_row} sequence(s) over its {n_model} model slots, "
                "heads and vocab rows split as tensor-parallel's and the "
                "rows stepped together: each MoE layer routes the whole "
                "batch (capacity and aux the batch's), slot (j, m) "
                "computes experts block m of capacity block j, the tokens "
                "and outputs moved between rows (all_to_all); each slot "
                "gathers its parameter parts over the data axis only, and "
                "block m of a leaf's gradient is summed on slot (0, m), "
                "which sends each piece its float32 slice to update")
    if n_model > 1:
        return (f"tensor-parallel: each of {n_rows} data row(s) computes "
                f"its {b_row} sequence(s) over its {n_model} model slots "
                "(heads, MLP columns and vocab rows split where the model "
                "axis divides them, else computed once on the row's first "
                "slot), the row-parallel partial sums and the embedding "
                "all-reduced over a row's slots (model_sum); each slot "
                "gathers its parameter parts over the data axis only, and "
                "block m of a leaf's gradient is summed on slot (0, m), "
                "which sends each piece its float32 slice to update")
    what = (f"each of {n_rows} data row(s) computes its {b_row} "
            f"sequence(s) on its first slot with the whole parameters "
            f"gathered there")
    if kind == "train":
        what += ("; the rows' gradients are summed on row 0's first slot, "
                 "which sends each piece its float32 slice to update")
    else:
        what += ("; its rows of each cache are fetched there and the "
                 "replaced ones sent back")
    return "row-gather: " + what + "; the model axis shards storage only"


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _shrink_layers(cfg, n_layers: int):
    kw = {"n_layers": n_layers}
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = max(1, n_layers)
    return dataclasses.replace(cfg, **kw)


def _full_cfg(arch, cfg_transform=None):
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    return cfg


def _model_flops(arch, shape, cfg_transform=None):
    cfg = _full_cfg(arch, cfg_transform)
    sh_spec = SHAPES[shape]
    n_active = cfg.active_param_count()
    if sh_spec.kind == "train":
        return 6 * n_active * sh_spec.seq_len * sh_spec.global_batch
    if sh_spec.kind == "prefill":
        return 2 * n_active * sh_spec.seq_len * sh_spec.global_batch
    return 2 * n_active * sh_spec.global_batch


def _row_inputs(inputs, kind: str, rows: slice):
    """The inputs of one row group: dim 0 of every batch leaf and cache
    leaf cut to ``rows`` (dim 1 of M-RoPE's [3, B, S] positions)."""
    def cut(name, x):
        if name == "positions" and x.dim() == 3:
            return x[:, rows]
        return x[rows]

    if kind == "train":
        state, batch = inputs
        return state, {k: cut(k, v) for k, v in batch.items()}
    out = [inputs[0]]
    for i, x in enumerate(inputs[1:]):
        if torch.is_tensor(x):
            out.append(cut("positions" if kind == "prefill" and i == 1
                           else "x", x))
        else:
            out.append(specs.map_cache(cut, x))
    return tuple(out)


def _mesh(multi_pod: bool, mesh_override):
    if mesh_override is not None:         # same chip count, another shape
        n = math.prod(mesh_override)
        return make_host_mesh(*mesh_override, devices=["meta"] * n)
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def cost_step(step_fn, inputs, cfg, kind: str, rules, *, batch: int,
              measurement: bool = True):
    """Trace ``step_fn(*inputs)`` (meta inputs as ``specs.build_cell``
    gives them, of a ``kind`` cell with ``batch`` sequences) for one row
    group of ``rules.mesh`` and reckon the mesh.  Returns (the record's
    numbers, the ``StepCounter``).
    ``measurement``: RWKV6's time-mix in its chunked form (``wkv_chunks``
    = 8); every other op is the one the port runs either way."""
    in_sh = specs.cell_in_shardings(inputs, cfg, rules, kind, batch)
    labels = torch.empty((batch,), device="meta")
    model = get_model(cfg)
    groups = row_groups(model, rules, {"labels": labels})
    rows = groups[0][1]
    row_in = _row_inputs(inputs, kind, rows) if len(groups) > 1 else inputs
    counter = StepCounter()
    ctx = lowering.unrolled(attn_chunks=None, wkv_chunks=8) \
        if measurement else contextlib.nullcontext()
    how = execution(model, rules) if kind == "train" else "row-gather"
    n_model = rules.mesh.shape["model"] if how != "row-gather" else 1
    # the tensor-parallel step of one data row, or the expert-parallel
    # step of every row, its model slots on meta
    all_rows = how == "expert-parallel"
    n_traced = len(groups) if all_rows else 1
    if all_rows:
        row_in = inputs
    row_rules = shd.use_rules(shd.default_rules(make_host_mesh(
        n_traced, n_model, devices=["meta"] * (n_traced * n_model)))) \
        if n_model > 1 else contextlib.nullcontext()
    t0 = time.time()
    with ctx, row_rules, counter:
        out = step_fn(*row_in)
    trace_s = time.time() - t0
    replaced = set()
    if kind in ("decode", "long_decode"):
        # the cache the step returns anew (clones, states, a KV tail) is
        # written back; a leaf it returns as it was, or does not return
        # (whisper's cross caches), is not
        for (_, full), (_, leaf), (_, new) in zip(
                _cache_leaves(inputs[2]), _cache_leaves(row_in[2]),
                _cache_leaves(out[1])):
            if new is not leaf:
                replaced.add(id(full))
    del out
    rec = reckon_slots(inputs, in_sh, rules, len(groups), rows, counter,
                       cfg, all_rows) if n_model > 1 else \
        reckon(kind, inputs, in_sh, rules, len(groups), rows, replaced,
               counter)
    rec.update({
        "n_chips": rules.mesh.size,
        "kernels": counter.kernels,
        "aten_ops": sum(counter.ops.values()),
        "trace_s": round(trace_s, 2),
        "execution": _execution(kind, len(groups), rows.stop - rows.start,
                                n_model, how),
        "wkv_chunked": measurement and kind in ("train", "prefill")
        and any(spec.kind == "rwkv" for spec in cfg.pattern),
        "model_params": cfg.param_count(),
        "model_params_active": cfg.active_param_count(),
    })
    return rec, counter


def trace_cell(arch: str, shape: str, *, multi_pod: bool = False,
               measurement: bool = True, cfg_transform=None,
               serve_params: bool = False, mesh_override=None) -> dict:
    """Trace one cell's row and reckon its mesh: the record's numbers,
    without status or timing."""
    mesh = _mesh(multi_pod, mesh_override)
    rules = shd.default_rules(
        mesh, seq_sharded=(shape in ("prefill_32k", "long_500k")),
        serve_params=serve_params)
    sh = SHAPES[shape]
    step_fn, inputs, cfg = specs.build_cell(arch, shape, cfg_transform)
    rec, _ = cost_step(step_fn, inputs, cfg, sh.kind, rules,
                       batch=sh.global_batch, measurement=measurement)
    rec["model_flops_per_device"] = \
        _model_flops(arch, shape, cfg_transform) / rec["n_chips"]
    rec["useful_flops_ratio"] = (rec["model_flops_per_device"]
                                 / rec["flops"] if rec["flops"] else None)
    return rec


def _cell_id(arch, shape, multi_pod, variant):
    mesh_tag = "pod2" if multi_pod else "pod1"
    return f"{arch}__{shape}__{mesh_tag}" + (f"__{variant}" if variant
                                             else "")


def _cached(path, cell_id, force):
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if cached.get("status") == "ok":
            print(f"[dryrun] {cell_id}: cached ok")
            return cached
    return None


def _write(path, rec) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape: str, *, multi_pod: bool, out_dir: str,
             force: bool = False, measurement: bool = None,
             variant: str = None, cfg_transform=None,
             serve_params: bool = False, mesh_override=None) -> dict:
    """Trace one cell at its config's depth and write its record.
    ``measurement`` (default on): RWKV6's time-mix traced in its
    chunked form; off, in the time loop the port runs."""
    if measurement is None:
        measurement = True
    mesh_tag = "pod2" if multi_pod else "pod1"
    cell_id = _cell_id(arch, shape, multi_pod, variant)
    path = os.path.join(out_dir, cell_id + ".json")
    cached = _cached(path, cell_id, force)
    if cached is not None:
        return cached
    rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
           "variant": variant, "measurement": bool(measurement),
           "status": "running"}
    t0 = time.time()
    try:
        rec.update(trace_cell(arch, shape, multi_pod=multi_pod,
                              measurement=measurement,
                              cfg_transform=cfg_transform,
                              serve_params=serve_params,
                              mesh_override=mesh_override))
        rec["status"] = "ok"
        print(f"[dryrun] {cell_id}: OK trace {rec['trace_s']:.1f}s "
              f"bottleneck={rec['roofline']['bottleneck']}")
    except Exception as e:                                   # noqa: BLE001
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] {cell_id}: FAIL {type(e).__name__}: {e}")
    rec["wall_s"] = round(time.time() - t0, 1)
    _write(path, rec)
    return rec


def _lin(v1, v2, l1, l2, l_real):
    """v(l_real) of the line through (l1, v1) and (l2, v2), for numbers
    and (nested) dicts of numbers; exact in integers where it can be."""
    if isinstance(v1, dict):
        return {k: _lin(v1.get(k, 0), v2.get(k, 0), l1, l2, l_real)
                for k in set(v1) | set(v2)}
    if isinstance(v1, bool) or not isinstance(v1, (int, float)):
        return v2
    num = (v2 - v1) * (l_real - l1)
    if isinstance(v1, int) and isinstance(v2, int) \
            and num % (l2 - l1) == 0:
        return v1 + num // (l2 - l1)
    return v1 + num / (l2 - l1)


_LINEAR = ("flops", "flops_by_dtype", "hbm_bytes", "collective_bytes",
           "link_bytes", "bytes_per_device", "bytes_by_region", "kernels",
           "aten_ops", "expert_flops")


def run_cell_extrapolated(arch: str, shape: str, *, out_dir: str,
                          force: bool = False, variant: str = None,
                          cfg_transform=None, serve_params: bool = False,
                          multi_pod: bool = False,
                          mesh_override=None) -> dict:
    """The cell by two-point depth extrapolation.

    For fixed input shapes every count here (FLOPs, bytes, collective
    bytes, kernel calls, op calls, and each part of the bytes per device)
    is affine in the layer count L: f(L) = base + per_l * L.  Two traces
    at L1 = 2 and L2 = 4 pattern repeats give (base, per_l); the record
    is f at the real depth.  Exact where every layer of the pattern is
    alike (a config's tail, a part of a pattern, is counted at the
    pattern's mean, as the reference does); the peak's activation part
    is affine once the remat-saved inputs dominate it.
    """
    cfg0 = _full_cfg(arch, cfg_transform)
    pat = len(cfg0.pattern)
    l1, l2 = 2 * pat, 4 * pat
    l_real = cfg0.n_layers

    def tf(nl):
        def f(cfg):
            if cfg_transform is not None:
                cfg = cfg_transform(cfg)
            return _shrink_layers(cfg, nl)
        return f

    mesh_tag = "pod2" if multi_pod else "pod1"
    cell_id = _cell_id(arch, shape, multi_pod, variant)
    path = os.path.join(out_dir, cell_id + ".json")
    cached = _cached(path, cell_id, force)
    if cached is not None:
        return cached
    sub = os.path.join(out_dir, "_extrap")
    t0 = time.time()
    r1 = run_cell(arch, shape, multi_pod=multi_pod, out_dir=sub, force=True,
                  variant=(variant or "") + f"L{l1}", cfg_transform=tf(l1),
                  serve_params=serve_params, mesh_override=mesh_override)
    r2 = run_cell(arch, shape, multi_pod=multi_pod, out_dir=sub, force=True,
                  variant=(variant or "") + f"L{l2}", cfg_transform=tf(l2),
                  serve_params=serve_params, mesh_override=mesh_override)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_tag, "variant": variant,
           "measurement": "extrapolated", "extrap_depths": [l1, l2],
           "status": "ok"}
    if r1["status"] != "ok" or r2["status"] != "ok":
        rec.update({"status": "error",
                    "error": r1.get("error") or r2.get("error")})
    else:
        rec.update({k: v for k, v in r2.items() if k not in rec})
        for key in _LINEAR:
            rec[key] = _lin(r1[key], r2[key], l1, l2, l_real)
        bpd = rec["bytes_per_device"]
        rec["fits"] = bpd["peak"] <= HBM_CAPACITY
        rec["roofline"] = roofline(rec["flops_by_dtype"], rec["hbm_bytes"],
                                   rec["link_bytes"])
        cfg = _full_cfg(arch, cfg_transform)
        rec["model_params"] = cfg.param_count()
        rec["model_params_active"] = cfg.active_param_count()
        rec["model_flops_per_device"] = \
            _model_flops(arch, shape, cfg_transform) / rec["n_chips"]
        rec["useful_flops_ratio"] = (rec["model_flops_per_device"]
                                     / rec["flops"] if rec["flops"]
                                     else None)
        rec["trace_s"] = round(r1["trace_s"] + r2["trace_s"], 2)
        print(f"[dryrun] {cell_id}: OK (extrapolated from L{l1},L{l2}) "
              f"bottleneck={rec['roofline']['bottleneck']}")
    rec["wall_s"] = round(time.time() - t0, 1)
    _write(path, rec)
    return rec


def table(out_dir: str, mesh: str = "pod1") -> str:
    """A markdown table of ``out_dir``'s records on one mesh: per cell the
    busiest device's FLOPs (bf16 / float32), HBM bytes, collective bytes,
    peak bytes, the three roofline terms and the bound."""
    rows = ["| arch | shape | FLOPs bf16 / f32 | HBM B | collective B | "
            "peak B (fits) | compute s | memory s | collective s | bound |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for arch in list_archs():
        for shape in SHAPES:
            path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                r = json.load(f)
            if r["status"] != "ok":
                rows.append(f"| {arch} | {shape} | {r['status']} |"
                            + " |" * 7)
                continue
            fl, ro = r["flops_by_dtype"], r["roofline"]
            rows.append(
                f"| {arch} | {shape} | {fl.get('bfloat16', 0):.3g} / "
                f"{fl.get('float32', 0):.3g} | {r['hbm_bytes']:.3g} | "
                f"{r['collective_bytes'].get('total', 0):.3g} | "
                f"{r['bytes_per_device']['peak']:.3g} "
                f"({'yes' if r['fits'] else 'no'}) | {ro['compute_s']:.3g} | "
                f"{ro['memory_s']:.3g} | {ro['collective_s']:.3g} | "
                f"{ro['bottleneck'].removesuffix('_s')} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                results.append(run_cell_extrapolated(
                    arch, shape, multi_pod=mp, out_dir=args.out,
                    force=args.force))
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n[dryrun] {n_ok}/{len(results)} cells ok")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
