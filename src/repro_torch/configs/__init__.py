"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

It knows the JAX package's ten architecture names.  The five attention-only
configurations are here field for field; the MoE (qwen3-moe, dbrx), RG-LRU
(recurrentgemma), RWKV6 and encoder-decoder (whisper) ones need model
parts not ported yet, and asking for them raises, naming ROADMAP Queue A
item 11a.
"""
from __future__ import annotations

import importlib

from ..core.store import _unported
from ..models.transformer import UNPORTED
from .shapes import SHAPES, ShapeSpec, get_shape

#: The architectures in the JAX package's registry order: the module of a
#: ported one, or (None, the part it needs that is not ported yet).
_ARCH_MODULES = {
    "recurrentgemma-9b": (None, "rglru"),
    "rwkv6-1.6b": (None, "rwkv"),
    "gemma2-2b": ("gemma2_2b", None),
    "phi3-mini-3.8b": ("phi3_mini_3_8b", None),
    "stablelm-3b": ("stablelm_3b", None),
    "codeqwen1.5-7b": ("codeqwen1_5_7b", None),
    "qwen3-moe-30b-a3b": (None, "moe"),
    "dbrx-132b": (None, "moe"),
    "whisper-base": (None, "encdec"),
    "qwen2-vl-2b": ("qwen2_vl_2b", None),
}


def list_archs():
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    module, missing = _ARCH_MODULES[arch]
    if module is None:
        raise _unported(f"arch {arch!r}", "11a", UNPORTED[missing])
    return importlib.import_module(f".{module}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


__all__ = ["SHAPES", "ShapeSpec", "get_shape", "list_archs", "get_config",
           "get_smoke_config"]
