"""Assigned input shapes (one set, shared by all LM archs).

  train_4k    : train_step,  seq 4096,   global_batch 256
  prefill_32k : serve prefill, seq 32768, global_batch 32
  decode_32k  : serve decode (1 new token, 32k KV cache), global_batch 128
  long_500k   : long-context decode (1 new token, 512k context), batch 1

``decode_*`` / ``long_*`` lower serve_step, not train_step.  long_500k uses
the paper's HNTL-KV retrieval attention for full-attention archs (DESIGN.md
SS Arch-applicability) and native recurrent state for SSM/hybrid archs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "long_decode", 524288, 1),
}


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]
