"""HNTL index construction (build-time) and the public search API.

``build`` runs on a device (the card unless the caller asks for the CPU):
k-means, the [N, G] preference distances, the [G, cap, d] grain scatter,
the per-grain covariances and eigendecompositions and the quantizers all
run there; only the capacity-bounded greedy pass of the balanced
assignment and the slot layout run on the host.  Float32 matrix products
run in full float32 (TF32 off) for the duration of a build or search.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import numpy as np
import torch

from . import kmeans as km
from . import layout, pca, planner, quantize
from .types import (GrainStore, HNTLConfig, HNTLIndex, RoutingPlane,
                    SearchResult)


@dataclasses.dataclass
class BuildInfo:
    var_captured: np.ndarray       # [G] variance fraction captured by k dims
    var_captured_mean: float       # size-weighted mean (paper's "PCA Var.")
    fill: np.ndarray               # [G] live fraction of capacity
    cap: int
    bytes_compact: int             # DRAM bytes of the compact scan tier
    bytes_raw: int                 # cold-tier bytes
    # Wall seconds per build phase (device work synchronised at each end).
    seconds: dict = dataclasses.field(default_factory=dict)


def int32_safe_qmax(k: int, bits: int = 16) -> int:
    """Largest quantization magnitude with exact int32 accumulation over k
    squared-diff terms: k * (2*qmax)^2 < 2^31."""
    qmax = int(np.sqrt((2 ** 31 - 1) / k) // 2)
    return min(qmax, (1 << (bits - 1)) - 1)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises when there is none, rather than
    running on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_fp32_matmul():
    """Matrix products at full precision inside the block: float32 ones in
    full float32 (no TF32), bf16 ones reduced in float32 (no
    reduced-precision split-K reduction), as the reference's
    ``preferred_element_type=float32``."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = prev


class _Phases:
    """Wall time per phase; synchronises the device at each phase end."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = {}
        self._t = time.perf_counter()

    def end(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def build(x, cfg: HNTLConfig, *, tags=None, ts=None, keep_raw: bool = True,
          centroids=None, device=None):
    """Build an HNTL index over corpus ``x`` [N, d] (numpy or tensor).

    ``device=None`` builds on the card and raises if there is none.
    ``centroids`` [G, d] skips k-means (parity with the JAX package goes
    through it).  Returns (HNTLIndex, BuildInfo).
    """
    dev = resolve_device(device)
    with full_fp32_matmul():
        return _build(x, cfg, tags=tags, ts=ts, keep_raw=keep_raw,
                      centroids=centroids, dev=dev)


def _f32(v, dev) -> torch.Tensor:
    """A float32 copy of an array or tensor on ``dev``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(v, dtype=np.float32), device=dev)


def _build(x, cfg, *, tags, ts, keep_raw, centroids, dev):
    phases = _Phases(dev)
    xt = _f32(x, dev)
    n, d = xt.shape
    if d != cfg.d:
        raise ValueError(f"corpus dim {d} != cfg.d {cfg.d}")
    g = cfg.n_grains
    phases.end("upload")

    # ---- level 1: grain partition -------------------------------------
    if g == 1:
        assign = np.zeros(n, dtype=np.int64)
    else:
        if centroids is None:
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            cents, _ = km.kmeans(xt, g, gen, iters=cfg.kmeans_iters)
        else:
            cents = _f32(centroids, dev)
        phases.end("kmeans")
        # capacity-bounded assignment so the Block-SoA padding stays sane
        cap_limit = layout.round_up(max(int(math.ceil(n / g * 1.6)),
                                        cfg.block), cfg.block)
        assign = km.balanced_assign(xt, cents, cap_limit)
    phases.end("assign")

    slot, assign, cap, counts = layout.pack_grains(assign, g, cfg.block)
    a_t = torch.from_numpy(assign).to(dev)
    s_t = torch.from_numpy(slot).to(dev)
    counts_t = torch.from_numpy(counts).to(dev)

    # exact means of the final members
    mu = torch.zeros((g, d), dtype=torch.float32, device=dev) \
        .index_add_(0, a_t, xt)
    mu = mu / torch.clamp(counts_t, min=1).to(torch.float32)[:, None]

    # [G, cap, d] scatter, centred in place (padded rows become -mu, as in
    # the JAX package; saves a second [G, cap, d] copy)
    xc = layout.scatter_to_grains(xt, a_t, s_t, g, cap)
    xc.sub_(mu[:, None, :])
    validg = layout.scatter_to_grains(
        torch.ones(n, dtype=torch.bool, device=dev), a_t, s_t, g, cap,
        fill=False)
    idsg = layout.scatter_to_grains(
        torch.arange(n, dtype=torch.int32, device=dev), a_t, s_t, g, cap,
        fill=-1)
    phases.end("scatter")

    # ---- per-grain PCA + quantization ----------------------------------
    cov = pca.grain_cov(xc, validg)
    phases.end("pca_cov")
    basis, sketch_basis, var_cap = pca.frames_from_cov(cov, cfg.k, cfg.s)
    del cov
    phases.end("pca_eigh")

    z = xc @ basis                                               # [G, cap, k]
    qeff = int32_safe_qmax(cfg.k, cfg.coord_bits)
    qmaxg = None
    if cfg.bit_alloc == "density":
        qmaxg = quantize.assign_grain_qmax(
            var_cap, counts_t, captured_min=cfg.int4_captured_min,
            min_rows=cfg.int4_min_rows)
    qm_fit = (torch.full((g,), qeff, dtype=torch.int32, device=dev)
              if qmaxg is None else qmaxg).to(torch.float32)
    scale = quantize.fit_scale(z, validg, qmax=qm_fit,
                               quantile=cfg.scale_quantile,
                               mult=cfg.scale_mult)                # [G]
    zq = quantize.quantize_coords(
        z, scale[:, None, None],
        qmax=qeff if qmaxg is None else qmaxg[:, None, None])

    vc2 = torch.sum(xc * xc, dim=-1)                              # [G, cap]
    r = torch.clamp(vc2 - torch.sum(z * z, dim=-1), min=0.0)
    sketch = sk_scale = None
    if cfg.s > 0:
        s_coords = xc @ sketch_basis                              # [G, cap, s]
        r = torch.clamp(r - torch.sum(s_coords * s_coords, dim=-1), min=0.0)
        sk_scale = quantize.fit_scale(s_coords, validg, qmax=127,
                                      quantile=cfg.scale_quantile,
                                      mult=cfg.scale_mult)
        sq = quantize.quantize_coords(s_coords, sk_scale[:, None, None],
                                      qmax=127).to(torch.int8)
        sketch = sq.transpose(1, 2).contiguous()                  # [G, s, cap]
    res_scale = quantize.fit_res_scale(r, validg)                 # [G]
    rq = quantize.quantize_residual(r, res_scale[:, None])
    del xc

    def grain_field(v, fill=0):
        if v is None:
            return None
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.astype(np.int64)
        return layout.scatter_to_grains(torch.from_numpy(v).to(dev), a_t,
                                        s_t, g, cap, fill=fill)

    grains = GrainStore(
        coords=zq.transpose(1, 2).contiguous(),                   # [G, k, cap]
        res=rq, sketch=sketch, ids=idsg, valid=validg, basis=basis, mu=mu,
        scale=scale, res_scale=res_scale,
        sketch_basis=sketch_basis if cfg.s > 0 else None,
        sketch_scale=sk_scale, tags=grain_field(tags), ts=grain_field(ts),
        qmaxg=qmaxg)
    index = HNTLIndex(routing=RoutingPlane(centroids=mu, sizes=counts_t),
                      grains=grains, raw=xt if keep_raw else None)
    phases.end("quantize")

    vc = var_cap.cpu().numpy()
    info = BuildInfo(
        var_captured=vc, var_captured_mean=float(np.sum(vc * counts)
                                                 / max(n, 1)),
        fill=counts.astype(np.float64) / cap, cap=cap,
        bytes_compact=int(n * cfg.bytes_per_vector),
        bytes_raw=int(n * d * 4) if keep_raw else 0,
        seconds=phases.seconds)
    return index, info


def search(index: HNTLIndex, q, cfg: HNTLConfig, *, topk: int = 10,
           mode: str = "B", scan_impl=None,
           extra_mask=None) -> SearchResult:
    """Search on the index's device; binds cfg to ``planner.search``.

    nprobe, pool and topk are clamped to the index's actual plane, as in
    the JAX package.  scan_impl: ScanPlane backend name
    (``core.scanplane``); None = "auto" ("fused" on the card).
    """
    dev = index.device
    qeff = int32_safe_qmax(cfg.k, cfg.coord_bits)
    nprobe = min(cfg.nprobe, index.grains.n_grains)
    n_slots = nprobe * index.grains.cap
    qt = torch.as_tensor(q, dtype=torch.float32).to(dev)
    if extra_mask is not None:
        extra_mask = torch.as_tensor(extra_mask, dtype=torch.bool).to(dev)
    with full_fp32_matmul():
        return planner.search(
            index, qt, nprobe=nprobe, pool=min(max(cfg.pool, topk), n_slots),
            topk=min(topk, n_slots), mode=mode,
            envelope_frac=cfg.envelope_frac, qeff=qeff, scan_impl=scan_impl,
            extra_mask=extra_mask)
