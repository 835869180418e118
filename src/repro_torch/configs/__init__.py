"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

Only phi3-mini-3.8b so far, the model the HNTL-KV example runs; the other
architectures of the JAX package's registry come with the transformer.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
}


def list_archs():
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(
        f".{_ARCH_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


__all__ = ["list_archs", "get_config", "get_smoke_config"]
