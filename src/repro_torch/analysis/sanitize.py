"""The runtime half of the hygiene gate: the port's ``jax.transfer_guard``.

- ``sync_guard()`` holds a block of code to zero implicit host<->device
  traffic.  On any device it installs a ``TorchDispatchMode`` that raises
  ``SyncError`` on the ops whose result the host must read: a scalar read
  (``aten._local_scalar_dense``: ``.item()``, ``int(t)``, ``bool(t)``),
  ``is_nonzero``, ``equal``, the data-dependent shapes (``nonzero``,
  ``masked_select``, the ``unique`` family, ``bincount``,
  ``repeat_interleave`` without ``output_size``) and boolean-mask
  indexing (``index`` / ``index_put`` with a bool index).  On the card it
  also sets ``torch.cuda.set_sync_debug_mode("error")``, which raises on
  every blocking copy (device to host, and host to device from pageable
  memory) and every stream or device sync, and restores the old mode on
  exit, also on an error.  ``nan_debug=True`` also records, without a
  sync, whether any floating output holds a NaN, and raises at the
  guard's exit naming the first op that made one (the counterpart of the
  JAX package's ``HNTL_NAN_DEBUG``; only around searches, because the
  build's fitters mask with NaN by design).
- ``fetch(*tensors)`` is the one sanctioned device-to-host read (the
  port's ``jax.device_get``): it leaves the guard for the copy and counts
  itself in every active guard.  ``fetch_async`` queues the same read
  into pinned memory behind an event and returns a ``Pending`` whose
  ``wait()`` gives the host tensors, so work queued after it overlaps the
  copy.  Both count as fetches.
- ``place(a, device)`` is the sanctioned host-to-device copy (the port's
  ``jax.device_put``): pinned memory and a copy queued on the current
  stream, so the host never waits for it.
- ``install()`` wraps ``VectorStore``'s three search-plane methods
  (``_search_segments_fused``, ``_sharded``, ``_tiered``) in the guard
  and marks each ``_hntl_sanitized``, as the JAX suite's ``HNTL_SANITIZE``
  mode does; ``uninstall()`` puts the originals back.
- ``suspended()`` lets everything through inside a guard: the tests run
  the kernels' plain versions (CPU only, never on the card's path) under
  it, so what the guard checks on the CPU is the glue around the kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: The store methods ``install()`` guards.
GUARDED_METHODS = ("_search_segments_fused", "_search_segments_sharded",
                   "_search_segments_tiered")


class SyncError(RuntimeError):
    """An implicit host<->device sync inside ``sync_guard()``."""


def _sync_ops() -> dict:
    """aten overload packets -> what the host would wait for."""
    aten = torch.ops.aten
    return {
        aten._local_scalar_dense: "a scalar read (.item(), int(), bool())",
        aten.is_nonzero: "a truth test (bool(t))",
        aten.equal: "torch.equal (a host bool)",
        aten.nonzero: "nonzero (a data-dependent shape)",
        aten.masked_select: "masked_select (a data-dependent shape)",
        aten._unique2: "unique (a data-dependent shape)",
        aten.unique_dim: "unique (a data-dependent shape)",
        aten.unique_consecutive: "unique_consecutive (a data-dependent "
                                 "shape)",
        aten.bincount: "bincount (its length is read from the data)",
    }


_BOOL_INDEXED = ("index", "index_put", "index_put_", "_index_put_impl_")


@dataclasses.dataclass
class Guard:
    """One active ``sync_guard()``: its fetch count and NaN records."""

    nan_debug: bool = False
    fetches: int = 0
    nan_flags: List = dataclasses.field(default_factory=list)


_STATE = threading.local()


def _active() -> List[Guard]:
    if not hasattr(_STATE, "guards"):
        _STATE.guards, _STATE.suspended = [], 0
    return _STATE.guards


def _is_suspended() -> bool:
    _active()
    return _STATE.suspended > 0


class _SyncMode(TorchDispatchMode):
    def __init__(self, guard: Guard):
        super().__init__()
        self.guard = guard
        self.ops = _sync_ops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _is_suspended():
            self._check(func, args, kwargs)
        out = func(*args, **kwargs)
        if self.guard.nan_debug and not _is_suspended():
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.is_floating_point() \
                        and t.numel() and t.device.type != "meta":
                    self.guard.nan_flags.append(
                        (str(func), torch.isnan(t).any()))
        return out

    def _check(self, func, args, kwargs) -> None:
        packet = func.overloadpacket
        why = self.ops.get(packet)
        if why is None and packet is torch.ops.aten.repeat_interleave \
                and func._overloadname == "Tensor" \
                and kwargs.get("output_size") is None:
            why = "repeat_interleave without output_size (its length is " \
                  "read from the data)"
        if why is None and packet.__name__ in _BOOL_INDEXED:
            indices = args[1] if len(args) > 1 else kwargs.get("indices")
            values = args[2] if len(args) > 2 else kwargs.get("values")
            masks = [i for i in (indices or ()) if isinstance(i, torch.Tensor)
                     and i.dtype in (torch.bool, torch.uint8)]
            # one mask and one value is ``masked_fill_`` inside index_put_
            # (``t[mask] = 0``): no sync
            fill = len(indices or ()) == 1 and isinstance(
                values, torch.Tensor) and values.numel() == 1 \
                and values.device.type == "cpu" and packet.__name__ != "index"
            if masks and not fill:
                why = "boolean-mask indexing (a data-dependent shape)"
        if why is not None:
            raise SyncError(f"sync_guard: {func} is {why}; read through "
                            f"sanitize.fetch or keep the value on the "
                            f"device")


@contextlib.contextmanager
def sync_guard(*, nan_debug: bool = False):
    """Raise ``SyncError`` on any implicit host<->device sync inside the
    block (see the module's docstring).  Yields the ``Guard``, whose
    ``fetches`` counts the sanctioned reads made inside it."""
    guard = Guard(nan_debug=nan_debug)
    stack = _active()
    old_mode = None
    if torch.cuda.is_available():
        old_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    stack.append(guard)
    try:
        with _SyncMode(guard):
            yield guard
    finally:
        stack.remove(guard)
        if old_mode is not None:
            torch.cuda.set_sync_debug_mode(old_mode)
    if guard.nan_flags:
        names = [n for n, _ in guard.nan_flags]
        dev = guard.nan_flags[0][1].device
        with suspended():
            hits = torch.stack([f.to(dev) for _, f in guard.nan_flags]) \
                .to("cpu")
        bad = np.flatnonzero(hits.numpy())
        if len(bad):
            raise FloatingPointError(
                f"sync_guard(nan_debug=True): {names[bad[0]]} made a NaN "
                f"({len(bad)} op(s) in all)")


@contextlib.contextmanager
def suspended():
    """Let every op and copy through inside an active guard (and lift the
    card's sync-debug mode meanwhile)."""
    _active()
    _STATE.suspended += 1
    old_mode = None
    if torch.cuda.is_available() and _STATE.suspended == 1:
        old_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        _STATE.suspended -= 1
        if old_mode is not None:
            torch.cuda.set_sync_debug_mode(old_mode)


def unguarded(fn):
    """``fn`` run under ``suspended()``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with suspended():
            return fn(*args, **kwargs)
    return wrapper


def _count() -> None:
    for g in _active():
        g.fetches += 1


def fetch(*tensors):
    """The sanctioned device-to-host read: each tensor (or None) as a host
    tensor, read after the work queued before it.  One tensor in, one out;
    several in, a tuple out.  Counts one fetch in every active guard."""
    with suspended():
        out = tuple(None if t is None else t.to("cpu") for t in tensors)
    _count()
    return out[0] if len(out) == 1 else out


class Pending:
    """An asynchronous ``fetch``: host tensors in pinned memory behind an
    event; ``wait()`` blocks until the copy has landed and returns them as
    ``fetch`` would."""

    def __init__(self, host: tuple, event):
        self._host = host
        self._event = event

    def wait(self):
        if self._event is not None:
            with suspended():
                self._event.synchronize()
            self._event = None
        return self._host[0] if len(self._host) == 1 else self._host


def fetch_async(*tensors) -> Pending:
    """Queue the sanctioned device-to-host read of ``tensors`` on the
    current stream (pinned buffers, non-blocking copies, one event) and
    return at once; work queued after it overlaps the copy.  On the CPU
    the copy is made here.  Counts one fetch in every active guard."""
    on_card = any(t is not None and t.device.type == "cuda"
                  for t in tensors)
    if not on_card:
        return Pending(fetch(*tensors) if len(tensors) > 1
                       else (fetch(*tensors),), None)
    host = []
    for t in tensors:
        if t is None:
            host.append(None)
            continue
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host.append(buf)
    event = torch.cuda.Event()
    event.record()
    _count()
    return Pending(tuple(host), event)


def place(a, device) -> torch.Tensor:
    """The sanctioned host-to-device copy of ``a`` (numpy array or tensor)
    onto ``device``: from the host through a fresh pinned buffer and a copy
    queued on the current stream, without stalling the host (PyTorch's
    pinned allocator keeps the buffer until the copy has run).  The buffer
    is always a copy, so the caller may reuse ``a`` at once, pinned or not.
    A tensor already on a device moves with ``.to``; on the CPU, ``a`` as a
    tensor, sharing its memory where it can."""
    t = a if isinstance(a, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    buf = t.pin_memory() if not t.is_pinned() \
        else torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return buf.to(device, non_blocking=True)


#: method name -> [guarded calls, fetches] since the last ``install()``
_STATS: dict = {}


def _guarded(orig, name: str):
    @functools.wraps(orig)
    def guarded(self, *args, **kwargs):
        with sync_guard() as g:
            out = orig(self, *args, **kwargs)
        calls = _STATS.setdefault(name, [0, 0])
        calls[0] += 1
        calls[1] += g.fetches
        return out
    guarded._hntl_sanitized = True
    guarded._hntl_original = orig
    return guarded


def install() -> None:
    """Wrap ``VectorStore``'s search-plane methods (``GUARDED_METHODS``) in
    ``sync_guard`` and mark each ``_hntl_sanitized``; ``install_stats()``
    counts their calls and fetches from here.  Idempotent."""
    from ..core.store import VectorStore
    _STATS.clear()
    for name in GUARDED_METHODS:
        orig = getattr(VectorStore, name)
        if getattr(orig, "_hntl_sanitized", False):
            continue
        setattr(VectorStore, name, _guarded(orig, name))


def install_stats() -> dict:
    """{method: {"calls": n, "fetches": m}} of the installed guards since
    the last ``install()``."""
    return {name: {"calls": c, "fetches": f}
            for name, (c, f) in _STATS.items()}


def uninstall() -> None:
    """Undo ``install()``."""
    from ..core.store import VectorStore
    for name in GUARDED_METHODS:
        fn = getattr(VectorStore, name)
        if getattr(fn, "_hntl_sanitized", False):
            setattr(VectorStore, name, fn._hntl_original)
