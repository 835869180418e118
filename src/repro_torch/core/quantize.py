"""Coordinate / residual quantization and the quantization envelope filter.

Paper Eq. 5:  z_hat = round(z / Delta),  r_hat = round(r / Delta_res),
with z_hat clipped to int16 and r_hat to the unsigned 16-bit range.
``torch.round`` rounds half to even, as ``jnp.round`` does.

The fitters take a leading batch of grains (the JAX package vmaps them):
z [..., cap, k] and mask [..., cap] give one scale per grain [...].
"""
from __future__ import annotations

from typing import Union

import torch

INT16_MAX = 32767
UINT16_MAX = 65535
INT4_QMAX = 7
INT8_QMAX = 127

Number = Union[int, float, torch.Tensor]


def _masked_quantile(v: torch.Tensor, valid: torch.Tensor,
                     quantile: float) -> torch.Tensor:
    """Linear-interpolated quantile of the valid entries along the last
    axis, in ``jnp.nanquantile``'s float32 arithmetic; NaN where no entry
    is valid."""
    n = valid.sum(dim=-1).to(torch.float32)                     # [...]
    s = torch.sort(torch.where(valid, v, torch.inf), dim=-1).values
    qpos = torch.tensor(quantile, dtype=torch.float32, device=v.device) \
        * (n - 1.0)
    low = torch.floor(qpos)
    high = torch.ceil(qpos)
    high_w = qpos - low
    low_w = 1.0 - high_w
    top = torch.clamp(n - 1.0, min=0.0)
    low_i = torch.minimum(torch.clamp(low, min=0.0), top).long()
    high_i = torch.minimum(torch.clamp(high, min=0.0), top).long()
    lv = torch.gather(s, -1, low_i[..., None])[..., 0]
    hv = torch.gather(s, -1, high_i[..., None])[..., 0]
    out = lv * low_w + hv * high_w
    return torch.where(n > 0, out, torch.nan)


def fit_scale(z: torch.Tensor, mask: torch.Tensor, qmax: Number = INT16_MAX,
              quantile: float = 0.9995, mult: float = 1.25) -> torch.Tensor:
    """Per-grain coordinate scale Delta from a high quantile of |z| over the
    valid slots only.  z [..., cap, k], mask [..., cap] -> [...]."""
    mag = torch.abs(z).flatten(-2)                              # [..., cap*k]
    valid = mask[..., :, None].expand(z.shape).flatten(-2)
    q = _masked_quantile(mag, valid, quantile)
    q = torch.where(torch.isfinite(q), q, 0.0)          # all-padding grain
    return torch.clamp(q * mult, min=1e-12) / qmax


def fit_res_scale(r: torch.Tensor, mask: torch.Tensor,
                  rmax: int = UINT16_MAX) -> torch.Tensor:
    """Per-grain residual scale from the max residual energy over the valid
    slots.  r [..., cap], mask [..., cap] -> [...]."""
    m = torch.amax(torch.where(mask, r, -torch.inf), dim=-1)
    m = torch.where(torch.isfinite(m), m, 0.0)          # all-padding grain
    return torch.clamp(m * 1.05, min=1e-12) / rmax


def quantize_coords(z: torch.Tensor, scale: torch.Tensor,
                    qmax: Number = INT16_MAX) -> torch.Tensor:
    """Eq. 5 left: signed-int16 coordinates."""
    q = torch.round(z / scale)
    if isinstance(qmax, torch.Tensor):
        qmax = qmax.to(q.dtype)
    return torch.clamp(q, -qmax, qmax).to(torch.int16)


def quantize_residual(r: torch.Tensor, res_scale: torch.Tensor,
                      rmax: int = UINT16_MAX) -> torch.Tensor:
    """Eq. 5 right: unsigned-16 residual energy (stored widened to int32)."""
    q = torch.round(r / res_scale)
    return torch.clamp(q, 0, rmax).to(torch.int32)


def saturation_fraction(z: torch.Tensor, scale: torch.Tensor,
                        qmax: Number = INT16_MAX) -> torch.Tensor:
    """Fraction of coordinates that clip when quantized with ``scale``.
    z [..., k] -> [...] in [0, 1]."""
    sat = (torch.abs(z / scale) >= qmax).to(torch.float32)
    return torch.mean(sat, dim=-1)


def envelope_keep(z_q: torch.Tensor, scale: torch.Tensor, frac: float,
                  qmax: Number = INT16_MAX) -> torch.Tensor:
    """Envelope filter verdict: True = keep grain, False = prune."""
    return saturation_fraction(z_q, scale, qmax) <= frac


def assign_grain_qmax(captured: torch.Tensor, live: torch.Tensor, *,
                      captured_min: float, min_rows: int,
                      hard_qmax: int = INT8_QMAX) -> torch.Tensor:
    """Per-grain quantization magnitude: int4 (7) for grains whose frame
    captures at least ``captured_min`` of the variance and that hold at
    least ``min_rows`` live rows, else ``hard_qmax``."""
    easy = torch.logical_and(captured >= captured_min, live >= min_rows)
    return torch.where(easy, INT4_QMAX, hard_qmax).to(torch.int32)


def pack_int4(q) -> torch.Tensor:
    """Pack values two signed nibbles per byte along the last axis.

    Floats are rounded first and NaNs pack as 0; every value is clipped
    to [-8, 7], so pack then unpack is the clip-to-[-8, 7] identity.  An
    odd-length last axis is zero-padded.  Returns uint8 [..., ceil(n/2)].
    """
    q = torch.as_tensor(q)
    if q.is_floating_point():
        q = torch.round(torch.where(torch.isnan(q), 0.0, q))
    q = torch.clamp(q, -8, 7).to(torch.int8)
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    lo = (q[..., 0::2] & 0x0F).to(torch.uint8)
    hi = (q[..., 1::2] & 0x0F).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 [..., ceil(n/2)] -> int8
    [..., n], the signed nibbles restored."""
    p = torch.as_tensor(packed).to(torch.uint8)
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (-1,))
    return out[..., :n]
