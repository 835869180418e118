"""How often the profiler drops kernel records in ``chip_smoke.py``'s
``trace_calls``, with and without its idle margin around each step.

``chip_smoke.device_ms`` times a kernel from a torch.profiler trace of 20
calls and takes the trace again when it holds fewer than 20 launches.
Short ``hntl_scan_single`` launches lost records now and then when they
began right at the start of the trace's active step.  This script traces
that kernel at the shapes ``chip_smoke.py`` times it at, in ``ROUNDS``
rounds: each round takes one trace of each shape with no margin and one
with ``TRACE_MARGIN_S``, so that both see the same state of the process.
It counts the traces that hold fewer launches than calls, prints one JSON
line, ``{"drops": {...}, "ok": ...}``, and exits 0 only if no trace with
the margin dropped a record.  It needs a card:

    python3 chip_trace_margin.py
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

#: Traces taken at each (shape, margin), one a round.
ROUNDS = 150
#: Calls in a trace, as ``device_ms`` makes them.
REPS = 20
#: (P, k, cap) of ``hntl_scan_single`` where ``chip_smoke.py`` times it:
#: a model's decode step, whisper's cross-attention, the gather plane.
SHAPES = ((256, 16, 4096), (64, 16, 4096), (4096, 32, 1664))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_trace_margin: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, chip_smoke.SRC)
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import scan_cases

    dev = torch.device("cuda")
    chip_smoke.device_phase(torch)
    margins = (0.0, chip_smoke.TRACE_MARGIN_S)
    calls, drops = {}, {}
    for p, k, cap in SHAPES:
        a = scan_cases.args(
            scan_cases.single(scan_cases.panels(0, p=p, q=1, k=k, cap=cap)),
            lambda v: torch.from_numpy(v).to(dev))
        for _ in range(3):
            hs.hntl_scan_single(*a)
        calls[f"P={p} k={k} cap={cap}"] = (
            lambda a=a: hs.hntl_scan_single(*a))
    torch.cuda.synchronize()
    for _ in range(ROUNDS):
        for shape, fn in calls.items():
            for margin in margins:
                evs = chip_smoke.trace_calls(torch, fn, REPS, margin)
                seen = sum(e.count for e in evs
                           if "hntl_scan_single_kernel" in e.key)
                key = f"{shape} margin={margin}s"
                drops[key] = drops.get(key, 0) + (seen < REPS)
    for key, short in drops.items():
        chip_smoke.log(f"{key}: {short} of {ROUNDS} traces held fewer "
                       f"than {REPS} launches")
    ok = all(v == 0 for key, v in drops.items()
             if key.endswith(f"margin={chip_smoke.TRACE_MARGIN_S}s"))
    print(json.dumps({"drops": drops, "traces": ROUNDS, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
