"""The cost counter that the kernel wrappers report to on meta tensors.

A kernel launched through ``ctypes`` dispatches no aten op, so a
``TorchDispatchMode`` that counts a step's work (``launch.dryrun``) would
not see it.  Each wrapper's meta branch therefore reports one call, with
the bytes and operations of its cost function, to the counter made
active here (``cost_counter``); with none active the report is dropped.
A counter is any object with ``kernel_call(name, nbytes, ops)``.
"""
from __future__ import annotations

import contextlib

_ACTIVE: list = []


@contextlib.contextmanager
def cost_counter(counter):
    """Make ``counter`` the one the wrappers report to inside the block."""
    _ACTIVE.append(counter)
    try:
        yield counter
    finally:
        _ACTIVE.pop()


def report(name: str, nbytes: int, ops: int) -> None:
    """One kernel call of ``nbytes`` bytes and ``ops`` operations."""
    if _ACTIVE:
        _ACTIVE[-1].kernel_call(name, nbytes, ops)


# The model slot whose work the ops in flight are (the tensor-parallel
# step's ``models.transformer.SlotParams``): a counter with
# ``slot_move`` attributes ops to slots and counts the bytes moved
# between them.
_SLOTS: list = []


def active() -> bool:
    """Whether a counter is active (slot bookkeeping costs host time
    otherwise spent on nothing)."""
    return bool(_ACTIVE)


@contextlib.contextmanager
def slot(m):
    """Attribute the ops inside the block to model slot ``m`` (None: to
    no slot)."""
    _SLOTS.append(m)
    try:
        yield
    finally:
        _SLOTS.pop()


def current_slot() -> tuple:
    """(whether a ``slot`` block is open, its slot)."""
    return (True, _SLOTS[-1]) if _SLOTS else (False, None)


def report_move(src: int, dst: int, nbytes: int,
                kind: str = "model_sum") -> None:
    """``nbytes`` moved from slot ``src`` to slot ``dst``: "model_sum"
    between the model slots of a data row, "all_to_all" between rows
    (the expert-parallel step's dispatch and return, whose slots are
    numbered j * model + m over the mesh)."""
    if _ACTIVE and src != dst and hasattr(_ACTIVE[-1], "slot_move"):
        _ACTIVE[-1].slot_move(src, dst, nbytes, kind)


# The named part of the model the ops in flight compute ("experts": the
# expert products of a MoE layer), for a counter that splits FLOPs by it.
_PARTS: list = []


@contextlib.contextmanager
def part(name: str):
    """Attribute the ops inside the block to part ``name``."""
    _PARTS.append(name)
    try:
        yield
    finally:
        _PARTS.pop()


def current_part():
    """The innermost open ``part`` block's name, or None."""
    return _PARTS[-1] if _PARTS else None
