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
