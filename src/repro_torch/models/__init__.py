"""Model pieces of the port and ``get_model``: the training and serving
API of every architecture family (``transformer``: dense, MoE, hybrid RG-LRU, RWKV6 and
VLM decoders; ``encdec``: the whisper encoder-decoder), exact and chunked
attention, and HNTL-KV retrieval attention (the paper's Mode B as
long-context decode).

This package's port of the JAX package's ``models/__init__.py``.  ``Model``
bundles one architecture's functions; the parameters are the module
``Model.init`` returns (a ``transformer.Transformer`` or an
``encdec.EncDec``), passed where the reference passes its parameter tree.
``loss`` is the training loss (``train.step`` takes its gradients); the
serving entry points record no autograd graph, so a model whose
parameters require gradients (fresh from training) serves as it is.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.index import resolve_device
from . import encdec, transformer
from .config import LayerSpec, ModelConfig

__all__ = ["LayerSpec", "ModelConfig", "Model", "get_model"]


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: ``init`` then makes
    meta tensors (shapes and dtypes, no bytes) through the same code."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed_or_generator=0, device=None):
        """A new model.  An int seeds a new ``torch.Generator`` on
        ``device`` (``None``: the card); a generator draws on its own
        device.  ``device="meta"`` makes the model's shapes alone (the
        sharding rules read them at full width without allocating)."""
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            dev = resolve_device(device)
            gen = _MetaGenerator() if dev.type == "meta" \
                else torch.Generator(device=dev)
            gen.manual_seed(int(seed_or_generator))
        if self.cfg.family == "encdec":
            return encdec.init_params(gen, self.cfg)
        return transformer.init_params(gen, self.cfg)

    # ---- training ------------------------------------------------------
    def loss(self, params, batch):
        """(loss, {"ce", "aux"}) of ``batch`` (``tokens``, ``labels`` with
        -100 for padding; ``frames`` for the encoder-decoder)."""
        if self.cfg.family == "encdec":
            return encdec.loss_fn(params, self.cfg, batch)
        return transformer.loss_fn(params, self.cfg, batch)

    # ---- serving -------------------------------------------------------
    def _decoder_only(self, entry: str) -> None:
        if self.cfg.family == "encdec":
            raise ValueError(
                f"Model.{entry} serves decoder-only models; {self.cfg.name!r}"
                " is an encoder-decoder (use encode / encdec_decode_step)")

    def prefill(self, params, tokens, **kw):
        self._decoder_only("prefill")
        return transformer.prefill(params, self.cfg, tokens, **kw)

    def decode_step(self, params, token, caches, pos):
        self._decoder_only("decode_step")
        return transformer.decode_step(params, self.cfg, token, caches, pos)

    def init_cache(self, batch: int, max_len: int, device=None):
        self._decoder_only("init_cache")
        return transformer.init_cache(self.cfg, batch, max_len, device)

    # ---- enc-dec serving ----------------------------------------------
    @torch.no_grad()
    def encode(self, params, frames):
        return encdec.encode(params, self.cfg, frames)

    def encdec_decode_step(self, params, token, self_cache, cross_cache,
                           pos):
        return encdec.decode_step(params, self.cfg, token, self_cache,
                                  cross_cache, pos)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
