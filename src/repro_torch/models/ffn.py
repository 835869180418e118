"""Channel mixers: the dense gated MLPs.

This package's port of the JAX package's ``models/ffn.py`` ``mlp_init`` /
``mlp_apply`` (swiglu, geglu, gelu).  The capacity-bounded mixture of
experts (``moe_init`` / ``moe_apply``) is not ported yet (ROADMAP Queue A
item 11a): ``transformer.check_ported`` refuses a configuration with
``n_experts``.
"""
from __future__ import annotations

import torch

from .common import ACTS, dense_init


def mlp_init(gen: torch.Generator, d: int, ff: int, kind: str, dtype):
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (d, ff), 0, dtype),
                "w_up": dense_init(gen, (d, ff), 0, dtype),
                "w_down": dense_init(gen, (ff, d), 0, dtype)}
    return {"w_up": dense_init(gen, (d, ff), 0, dtype),
            "w_down": dense_init(gen, (ff, d), 0, dtype)}


def mlp_apply(params, x, kind: str):
    if kind in ("swiglu", "geglu"):
        act = ACTS["silu"] if kind == "swiglu" else ACTS["gelu"]
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = ACTS["gelu"](x @ params["w_up"])
    return h @ params["w_down"]

