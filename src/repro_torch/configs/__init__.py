"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

It knows the JAX package's ten architecture names, in its registry order,
and holds each configuration field for field.
"""
from __future__ import annotations

import importlib

from .shapes import SHAPES, ShapeSpec, get_shape

_ARCH_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "gemma2-2b": "gemma2_2b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "stablelm-3b": "stablelm_3b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "whisper-base": "whisper_base",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def list_archs():
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


__all__ = ["SHAPES", "ShapeSpec", "get_shape", "list_archs", "get_config",
           "get_smoke_config"]
