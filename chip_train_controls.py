"""Controls for ``chip_smoke.py``'s training gates: each gate passes on
the code as it is and fails on a planted fault.

- (a) holds the card's float32 loss and gradients of phi3-mini (full
  width, cut in depth) to the CPU's.  Its fault runs the card's backward
  pass, and remat's recomputation inside it, with TF32 products, as a
  backward outside ``full_fp32_matmul`` would.
- (b) holds a step over 4 microbatches to one over the whole batch.  Its
  fault keeps only the last microbatch's gradient.
- mesh (a) holds phi3-mini-3.8b's float32 loss and gradients on a 2 x 2
  mesh (row 0 padded) to the one-slot step's.  Its fault averages the
  rows' means (every row weighted alike, whatever its token count).
- mesh (b) holds int8_ef's first reduced gradient of qwen2-vl-2b within
  half the consensus scale of the exact mean.  Its fault quantizes each
  slot with its own scale (no maximum over slots).

Each gate logs how far it was from its limit.  The script prints one JSON
line, ``{"controls": [...], "ok": ...}``, and exits 0 only if every gate
passes on the sound code and fails on its fault.  It needs a card:

    python3 chip_train_controls.py
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import unittest.mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402


def tf32_backward(torch):
    """``torch.autograd.grad`` on the card with TF32 products."""
    real = torch.autograd.grad
    m = torch.backends.cuda.matmul

    def grad(outputs, inputs, *args, **kwargs):
        if outputs.device.type != "cuda":
            return real(outputs, inputs, *args, **kwargs)
        prev, m.allow_tf32 = m.allow_tf32, True
        try:
            return real(outputs, inputs, *args, **kwargs)
        finally:
            m.allow_tf32 = prev
    return unittest.mock.patch.object(torch.autograd, "grad", grad)


def last_microbatch_only():
    """A step over 4 microbatches that keeps only the last one's gradient
    (the others' are zeroed, the last one's scaled by 4 so that the
    step's average is that gradient)."""
    from repro_torch.train import step as step_mod

    real, calls = step_mod.value_and_grad, [0]
    full = chip_smoke.TRAIN_MB_SHAPE[0]

    def value_and_grad(model, params, batch, acc=None):
        loss, metrics, grads = real(model, params, batch)
        if batch["tokens"].shape[0] < full:
            calls[0] += 1
            scale = 4.0 if calls[0] % 4 == 0 else 0.0
            grads = {k: v * scale for k, v in grads.items()}
        if acc is None:
            return loss, metrics, grads
        for k, v in grads.items():
            acc[k] = acc[k].add_(v) if k in acc else v
        return loss, metrics, acc
    return unittest.mock.patch.object(step_mod, "value_and_grad",
                                      value_and_grad)


def rows_means_averaged():
    """The mesh step weighting every row alike: each row's token count
    read as 1, so each row's mean counts 1 / rows."""
    from repro_torch.train import step as step_mod

    return unittest.mock.patch.object(step_mod, "_tokens",
                                      lambda batch, rows: 1)


def per_slot_scales():
    """int8_ef without the consensus: each slot quantizes with its own
    scale, and slot 0's dequantizes the sum."""
    import torch
    from repro_torch.distributed import compression

    return unittest.mock.patch.object(
        compression, "_slot_scales",
        lambda local: [torch.clamp(s, min=1e-12) for s in local])


def run(torch, dev, label, gate, fault, expect_pass):
    with fault:
        try:
            got = gate()
            passed, why = True, None
        except chip_smoke.SmokeFailure as e:
            got, passed, why = None, False, str(e)
    chip_smoke.free_card(torch, dev)
    ok = passed == expect_pass
    chip_smoke.log(f"control {label}: gate {'passed' if passed else 'failed'}"
                   f" ({'as expected' if ok else 'NOT as expected'})"
                   + (f": {why}" if why else ""))
    return dict(control=label, passed=passed, expected=expect_pass, ok=ok,
                result=got, failure=why)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_train_controls: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, chip_smoke.SRC)
    dev = torch.device("cuda")
    chip_smoke.device_phase(torch)
    none = contextlib.nullcontext()
    grad = lambda: chip_smoke.train_grad_check(torch, np, dev)  # noqa: E731
    mb = lambda: chip_smoke.train_microbatches(torch, np, dev)  # noqa: E731
    mesh = lambda: chip_smoke.mesh_grad_check(torch, np, dev)  # noqa: E731
    comp = lambda: chip_smoke.compression_gate(torch, np, dev)  # noqa: E731
    rows = [run(torch, dev, "(a) sound", grad, none, True),
            run(torch, dev, "(a) TF32 backward", grad, tf32_backward(torch),
                False),
            run(torch, dev, "(b) sound", mb, none, True),
            run(torch, dev, "(b) last microbatch only", mb,
                last_microbatch_only(), False),
            run(torch, dev, "mesh (a) sound", mesh, none, True),
            run(torch, dev, "mesh (a) rows' means averaged", mesh,
                rows_means_averaged(), False),
            run(torch, dev, "mesh (b) sound", comp, none, True),
            run(torch, dev, "mesh (b) per-slot scales", comp,
                per_slot_scales(), False)]
    ok = all(r["ok"] for r in rows)
    print(json.dumps({"controls": rows, "ok": ok}, default=float))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
