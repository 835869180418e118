"""Lowering-mode flags: the loop shapes the dry-run measures with.

This package's port of the JAX package's ``models/lowering.py``.  There
the flags unroll every structural loop before an AOT compile, because
XLA's cost analysis counts a while-loop body once whatever its trip
count.  The port has no compiler between the model and its count: the
dry-run (``launch.dryrun``) traces each op the step dispatches on meta
tensors, and every loop of the port already runs in Python, so the
reference's ``unroll_layers`` has no counterpart here.  The two flags
that change what runs keep the reference's meaning:

  - ``attn_chunks``: the chunked attention walks the keys in that many
    chunks (``kv_chunk = max(128, ceil(t / attn_chunks))``);
  - ``wkv_chunks``: RWKV6's time-mix runs the chunked block-parallel
    WKV (``rwkv6._wkv_chunked``, min(wkv_chunks, S) chunks) in place of
    the step scan, a Python loop over time (the dry-run sets only this
    one: tracing the time loop takes ~20 minutes a cell).

Runtime behaviour is unchanged by default (flags off).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass
class LoweringFlags:
    attn_chunks: Optional[int] = None     # key-chunk count of attention
    wkv_chunks: Optional[int] = None      # chunk count of RWKV6's WKV


_STACK = [LoweringFlags()]


def flags() -> LoweringFlags:
    return _STACK[-1]


@contextlib.contextmanager
def unrolled(attn_chunks: Optional[int] = 8,
             wkv_chunks: Optional[int] = 8):
    _STACK.append(LoweringFlags(attn_chunks=attn_chunks,
                                wkv_chunks=wkv_chunks))
    try:
        yield
    finally:
        _STACK.pop()
