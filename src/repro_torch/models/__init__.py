"""Model pieces of the port and ``get_model``: the serving API of the
attention-only decoders (``transformer``), exact and chunked attention,
and HNTL-KV retrieval attention (the paper's Mode B as long-context
decode).

This package's port of the JAX package's ``models/__init__.py``.  ``Model``
bundles one architecture's functions; the parameters are the module
``Model.init`` returns (a ``transformer.Transformer``), passed where the
reference passes its parameter tree.  Training (``loss``, item 11b), the
encoder-decoder (``encode``, ``encdec_decode_step``) and the MoE, RG-LRU
and RWKV6 families (item 11a) are not ported yet and are refused.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.index import resolve_device
from ..core.store import _unported
from . import transformer
from .config import LayerSpec, ModelConfig

__all__ = ["LayerSpec", "ModelConfig", "Model", "get_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed_or_generator=0, device=None):
        """A new model.  An int seeds a new ``torch.Generator`` on
        ``device`` (``None``: the card); a generator draws on its own
        device."""
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(seed_or_generator))
        return transformer.init_params(gen, self.cfg)

    # ---- serving -------------------------------------------------------
    def prefill(self, params, tokens, **kw):
        return transformer.prefill(params, self.cfg, tokens, **kw)

    def decode_step(self, params, token, caches, pos):
        return transformer.decode_step(params, self.cfg, token, caches, pos)

    def init_cache(self, batch: int, max_len: int, device=None):
        return transformer.init_cache(self.cfg, batch, max_len, device)

    # ---- enc-dec serving ----------------------------------------------
    def encode(self, params, frames):
        raise _unported("Model.encode", "11a",
                        transformer.UNPORTED["encdec"])

    def encdec_decode_step(self, params, token, self_cache, cross_cache,
                           pos):
        raise _unported("Model.encdec_decode_step", "11a",
                        transformer.UNPORTED["encdec"])


def get_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``; a configuration that needs a part not ported
    yet (MoE, RG-LRU, RWKV6, encoder-decoder) raises, naming item 11a."""
    transformer.check_ported(cfg)
    return Model(cfg)
