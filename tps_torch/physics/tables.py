"""Table interpolators (1-D linear with log-scale options, 2-D bilinear).

The port of the JAX package's physics/tables.py (reference: src/table.cpp:
79-109 LinearTable with x/f log scaling and clamped end-interval
extrapolation; TableInterpolator2D for LTE property tables), plus the
two-argument lookup `_eval2` of its physics/lte.py.

The abscissae and segment coefficients are formed once in numpy f64 (the
JAX package forms the same ones); a lookup is `torch.searchsorted` (left,
as jnp.searchsorted) and the same a + b x, so both packages give the same
bits in f64, also outside the table's range.  The device copies are made
on a lookup's first call for a (dtype, device) and kept: a captured step
graph must not copy from the host, and its warm-up step makes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def _on(cache, key, arrays):
    """The arrays as tensors on key = (dtype, device), made once."""
    out = cache.get(key)
    if out is None:
        out = tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=key[0],
                                    device=key[1])
                    for a in arrays)
        cache[key] = out
    return out


@dataclass(frozen=True, eq=False)
class LinearTable:
    """Piecewise-linear 1-D table; optional log scaling of either axis.

    Evaluation outside the range uses the end intervals (linear
    extrapolation), matching the reference findInterval clamping.
    """

    x: np.ndarray
    f: np.ndarray
    x_log: bool = False
    f_log: bool = False
    _dev: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "x", np.asarray(self.x, dtype=np.float64))
        object.__setattr__(self, "f", np.asarray(self.f, dtype=np.float64))
        assert self.x.ndim == 1 and self.x.shape == self.f.shape
        assert (np.diff(self.x) > 0).all(), "table abscissae must increase"

    def _coeffs(self):
        xs = np.log(self.x) if self.x_log else self.x
        fs = np.log(self.f) if self.f_log else self.f
        b = np.diff(fs) / np.diff(xs)
        a = fs[:-1] - b * xs[:-1]
        return xs, a, b

    def _lookup(self, xq):
        xs, a, b = _on(self._dev, (xq.dtype, xq.device), self._coeffs())
        xt = torch.log(xq) if self.x_log else xq
        idx = torch.clamp(torch.searchsorted(xs, xt.contiguous()) - 1,
                          0, a.shape[0] - 1)
        return xt, idx, a, b

    def __call__(self, xq):
        xt, idx, a, b = self._lookup(xq)
        ft = a[idx] + b[idx] * xt
        return torch.exp(ft) if self.f_log else ft

    def deriv(self, xq):
        """df/dx (reference eval_x)."""
        xt, idx, a, b = self._lookup(xq)
        slope = b[idx]
        out = slope * (1.0 / xq if self.x_log else 1.0)
        if self.f_log:
            out = out * torch.exp(a[idx] + slope * xt)
        return out


@dataclass(frozen=True, eq=False)
class Table2D:
    """Bilinear 2-D table f(x, y) with clamped evaluation (the role of the
    reference's GslTableInterpolator2D for LTE mixtures/transport)."""

    x: np.ndarray
    y: np.ndarray
    f: np.ndarray  # [nx, ny]
    _dev: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "x", np.asarray(self.x, dtype=np.float64))
        object.__setattr__(self, "y", np.asarray(self.y, dtype=np.float64))
        object.__setattr__(self, "f", np.asarray(self.f, dtype=np.float64))
        assert self.f.shape == (len(self.x), len(self.y))

    def __call__(self, xq, yq):
        x, y, f = _on(self._dev, (xq.dtype, xq.device),
                      (self.x, self.y, self.f))
        xq = torch.clamp(xq, float(self.x[0]), float(self.x[-1]))
        yq = torch.clamp(yq, float(self.y[0]), float(self.y[-1]))
        i = torch.clamp(torch.searchsorted(x, xq.contiguous()) - 1,
                        0, len(self.x) - 2)
        j = torch.clamp(torch.searchsorted(y, yq.contiguous()) - 1,
                        0, len(self.y) - 2)
        tx = (xq - x[i]) / (x[i + 1] - x[i])
        ty = (yq - y[j]) / (y[j + 1] - y[j])
        return (
            f[i, j] * (1 - tx) * (1 - ty)
            + f[i + 1, j] * tx * (1 - ty)
            + f[i, j + 1] * (1 - tx) * ty
            + f[i + 1, j + 1] * tx * ty
        )


def _eval2(table, a, b):
    """Evaluate a Table2D(a, b) or a 1-D LinearTable(a)
    (tps_tpu/physics/lte.py:21)."""
    if isinstance(table, Table2D):
        return table(a, b)
    return table(a)
