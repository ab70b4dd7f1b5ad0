"""Binary entropy, its inverse, and uncertainty bins (paper Eq. 4/5/8).

Port of ``repro.core.entropy``.  Entropies are base-2 so h lies in [0, 1]
and the paper's decision-table bins apply verbatim.  The inverse of binary
entropy (Eq. 8) is a monotone 4096-bin lookup table over the upper branch
p in [0.5, 1], built once in numpy — bit-identical to the reference's table,
since both run the same numpy code — and read with gather + linear
interpolation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_LOG2 = 0.6931471805599453  # ln 2


def binary_entropy(p: torch.Tensor) -> torch.Tensor:
    """H(p) = -p log2 p - (1-p) log2 (1-p), safe at p in {0, 1} (paper Eq. 5)."""
    p = torch.clamp(p, 0.0, 1.0)

    def _xlog2x(x):
        return torch.where(x > 0, x * torch.log(torch.clamp_min(x, 1e-38)) / _LOG2, 0.0)

    return -(_xlog2x(p) + _xlog2x(1.0 - p))


@functools.lru_cache(maxsize=8)
def _inverse_entropy_table(bins: int) -> np.ndarray:
    """Tabulate p_hi(h): the UPPER root of H(p) = h, p in [0.5, 1].

    The grid is uniform in h.  Built by sampling p densely (extra-densely
    near p = 1, where dH/dp blows up) and interpolating the (h, p) pairs
    onto the uniform h grid.  Returned as a read-only numpy array so the
    cache can never be mutated through a caller's view.
    """
    p_dense = 1.0 - np.logspace(-12, np.log10(0.5), 65536)[::-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        h_dense = -(
            np.where(p_dense > 0, p_dense * np.log2(np.maximum(p_dense, 1e-300)), 0.0)
            + np.where(
                p_dense < 1,
                (1 - p_dense) * np.log2(np.maximum(1 - p_dense, 1e-300)),
                0.0,
            )
        )
    h_grid = np.linspace(0.0, 1.0, bins)
    # np.interp needs ascending x: h_dense is descending as p ascends.
    p_of_h = np.interp(h_grid, h_dense[::-1], p_dense[::-1])
    table = np.asarray(p_of_h, "float32")
    table.setflags(write=False)
    return table


def inverse_entropy_table(bins: int, device=None) -> torch.Tensor:
    """The ``[bins]`` f32 inverse-entropy LUT as a tensor on ``device``."""
    return torch.tensor(_inverse_entropy_table(bins), device=device)


def lut_lerp(h_hat: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Upper entropy root by LUT gather + linear interpolation.

    Rounds step by step like the scoring kernels (``x = h*(B-1)``,
    ``p_lo*(1-frac) + p_hi*frac``, each product rounded before the sum),
    so the plain path and the kernels agree bitwise.
    """
    bins = lut.shape[0]
    x = h_hat * (bins - 1)
    lo = torch.floor(x)
    frac = x - lo
    hi = torch.clamp_max(lo + 1.0, float(bins - 1))
    return lut[lo.long()] * (1.0 - frac) + lut[hi.long()] * frac


def inverse_entropy_upper(h: torch.Tensor, bins: int = 4096) -> torch.Tensor:
    """Upper root p >= 0.5 of H(p) = h via LUT + linear interpolation (Eq. 8)."""
    return lut_lerp(torch.clamp(h, 0.0, 1.0), inverse_entropy_table(bins, h.device))


def inverse_entropy_lower(h: torch.Tensor, bins: int = 4096) -> torch.Tensor:
    """Lower root p <= 0.5 of H(p) = h (the pessimistic solution of Eq. 8)."""
    return 1.0 - inverse_entropy_upper(h, bins)


def uncertainty_bin(h: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Map uncertainty h in [0,1] to a decision-table bin index (paper Table 3)."""
    b = torch.floor(torch.clamp(h, 0.0, 1.0 - 1e-7) * num_bins).to(torch.int64)
    return torch.clamp(b, 0, num_bins - 1)
