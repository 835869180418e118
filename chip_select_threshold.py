"""Where ``fused_scan_select``'s block-sort path should start, and what the
wide paths cost, on the card.

``csrc/fused_select.cu`` builds a pair's list of L = min(width, cap) keys
with one warp's sorted carry below ``kBlockSortL`` and with a CTA's
block-wide radix sort at or above it (then a multi-way merge).  This
script builds the file twice more, with the threshold overridden at each
end (``-DFUSED_SELECT_BLOCK_SORT_L``: 1, every list block-sorted; 2^30,
none), and at L = 256 .. 2048 times both forms in turns (warp, block,
block, warp), each held to the plain version first (``torch.equal``):

- "fused": Q=256 P=16 G=1024 k=32 s=8 cap=2048, width = L (the fused
  plane with a pool of L);
- "stage 1": the cascade's stage-1 form (k=1 zero panel) at Q=256 P=16
  G=1024 cap = L, width = P * L.

Then it times the default build (the source's own threshold) at the wide
shapes ``chip_smoke.py`` reports: stage 1 at cap 1,664 and widths 26,624 /
4,096 / 15,974, and lists above 8,192 keys (Q=256 P=16 G=16 cap=22,912:
k=32 s=8 width 10,000; k=1 width 366,592), each with its parts and the
time of ``torch.sort`` over the same number of int64 keys.  Device time
per call is CUPTI (``chip_smoke.device_ms``).  It prints one JSON line
last but one and ``{"ok": true}`` last; it needs a card:

    python3 chip_select_threshold.py
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

#: Per-pair list lengths L timed with both forms.
LENGTHS = (256, 384, 512, 768, 1024, 1536, 2048)
#: The threshold overrides: every list block-sorted, none.
VARIANTS = {"block": 1, "warp": 1 << 30}
REPS = 10


def build_variants():
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "select_threshold"
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "fused_select.cu"
    procs = {}
    for name, thr in VARIANTS.items():
        so = out / f"fused_select_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               f"-DFUSED_SELECT_BLOCK_SORT_L={thr}", "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        chip_smoke.check(proc.returncode == 0, f"nvcc ({name}): {text}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def use(lib):
    """Point ``fused_select``'s wrapper at ``lib``."""
    from repro_torch.kernels import _build

    _build._LIBS["fused_select"] = lib


def kernels_of(width, cap, bsl):
    from repro_torch.kernels import fused_select as fsel

    block = min(width, cap) >= bsl
    if not block and width <= fsel.SMEM_WIDTH:
        return chip_smoke.SELECT_KERNELS
    return ("fused_scan_select_block_probe_kernel" if block
            else "fused_scan_select_probe_kernel",
            "fused_scan_select_corank_kernel",
            "fused_scan_select_multiway_merge_kernel")


def timed(torch, fsel, args, kw, width, label, bsl):
    chip_smoke.hold(torch, fsel, args, kw, width, label)
    run = lambda: fsel.fused_scan_select(*args, width=width, **kw)  # noqa
    for _ in range(3):
        run()
    ms, parts, _ = chip_smoke.device_ms(
        torch, run, kernels_of(width, args[4].shape[2], bsl), reps=REPS)
    return ms, {chip_smoke.SELECT_PARTS[k]: v for k, v in parts.items()}


def sort_ms(torch, n_rows, n_keys):
    """``torch.sort(keys, dim=-1, stable=True)`` over [n_rows, n_keys]
    int64 keys: one library call that sorts as many keys as the merge."""
    keys = torch.randint(-2 ** 62, 2 ** 62, (n_rows, n_keys),
                         dtype=torch.int64, device="cuda")
    run = lambda: torch.sort(keys, dim=-1, stable=True)  # noqa: E731
    run()
    ms, _, _ = chip_smoke.device_ms(torch, run, (), reps=REPS)
    return ms


def main() -> int:
    import numpy as np  # noqa: F401
    import torch

    if not torch.cuda.is_available():
        print("chip_select_threshold: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, chip_smoke.SRC)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.kernels import select_cases as sc

    dev = torch.device("cuda")
    chip_smoke.device_phase(torch)
    libs = build_variants()
    default = _build.library("fused_select")
    conv = lambda v: torch.from_numpy(v).to(dev)  # noqa: E731
    fused = sc.split(sc.random_inputs(0, q=256, p=16, g=1024, k=32,
                                      cap=2048, s=8), conv)
    out = {"sweep": {}, "wide": {}}
    for L in LENGTHS:
        stage1 = sc.split(sc.stage1_inputs(L, q=256, p=16, g=1024, cap=L,
                                           s=8), conv)
        for family, (args, kw), width in (("fused", fused, L),
                                          ("stage 1", stage1, 16 * L)):
            row = {}
            for name in ("warp", "block", "block", "warp"):
                use(libs[name])
                ms, parts = timed(torch, fsel, args, kw, width,
                                  f"{family} L={L} {name}",
                                  VARIANTS[name])
                row.setdefault(name, []).append(ms)
                row[f"{name} parts"] = parts
            out["sweep"][f"{family} L={L}"] = row
            chip_smoke.log(
                f"threshold sweep, {family} L={L} width={width}: warp "
                f"{row['warp']} ms, block {row['block']} ms (CUPTI per "
                f"call; parts, last: warp {row['warp parts']}, block "
                f"{row['block parts']})")
        del stage1
    del fused
    use(default)
    bsl = fsel.block_sort_length()
    chip_smoke.log(f"default build: kBlockSortL = {bsl}")
    wide = {}
    st1 = sc.split(sc.stage1_inputs(7, q=256, p=16, g=1024, cap=1664, s=8),
                   conv)
    for width in (16 * 1664, 4096, 15974):
        wide[f"stage 1 cap=1664 width={width}"] = (st1, width)
    wide["long k=32 cap=22912 width=10000"] = (sc.split(sc.random_inputs(
        8, q=256, p=16, g=16, k=32, cap=22912, s=8), conv), 10000)
    wide["long stage 1 cap=22912 width=366592"] = (sc.split(
        sc.stage1_inputs(9, q=256, p=16, g=16, cap=22912, s=8), conv),
        16 * 22912)
    for label, ((args, kw), width) in wide.items():
        ms, parts = timed(torch, fsel, args, kw, width, label, bsl)
        cap = args[4].shape[2]
        srt = sort_ms(torch, 256, 16 * min(width, cap))
        out["wide"][label] = dict(ms=ms, parts=parts, torch_sort_ms=srt)
        chip_smoke.log(f"default build, {label}: {ms:.4f} ms per call "
                       f"(CUPTI; {parts}); torch.sort(stable) over [256, "
                       f"{16 * min(width, cap)}] int64 keys {srt:.4f} ms")
    chip_smoke.log(json.dumps(out))
    chip_smoke.log(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
