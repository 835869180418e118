"""The launch glue every kernel wrapper shares: which devices a wrapper
takes, and one call of a ``csrc`` library's ``extern "C"`` launch on the
current stream, its CUDA error raised.

Each launch entry takes its arguments, then the stream, and returns
``cudaGetLastError()`` after the launch; each library has an
``<name>_error_string`` that turns that code into CUDA's text.
"""
from __future__ import annotations

import ctypes

import torch


def device_kind(fn: str, t: torch.Tensor, *, meta: bool = False) -> str:
    """``t``'s device type: "cpu", "cuda", or "meta" where the wrapper
    ``fn`` takes meta tensors; any other device raises."""
    kinds = ("cpu", "cuda", "meta") if meta else ("cpu", "cuda")
    if t.device.type not in kinds:
        raise ValueError(f"{fn}: no kernel for device {t.device}")
    return t.device.type


def _arg(a):
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if a is None:
        return ctypes.c_void_p(None)
    return a


def launch(fn: str, lib: ctypes.CDLL, entry: str, error_string: str,
           dev: torch.device, *args) -> None:
    """``lib.<entry>(*args, stream)`` on ``dev``'s current stream, a tensor
    passed as its data pointer and None as a null pointer.  A non-zero
    return raises RuntimeError naming ``fn``, with the text of
    ``lib.<error_string>``."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*map(_arg, args), ctypes.c_void_p(stream))
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
