"""Geometric sponge multiplier fields for the low-Mach path.

The port of the JAX package's solvers/lomach/sponge.py (the role of the
reference GeometricSponge, src/geometricSponge.cpp: spongeUniform,
spongePlane, spongeCylinder, spongeAnnulus): a static
viscosity-multiplier field >= 1 assembled from uniform, half-space (plane),
axis-aligned cylinder, and y-axis annulus regions, each ramped with a tanh
profile of the given width and combined by pointwise max.  The field is
computed once in numpy over the H1 dof coordinates and kept as one
static tensor: the calorically-perfect thermo scales its conductivity by
it, the Tomboulides flows (planar and axisymmetric) their total viscosity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...fem import h1

from .base import SpongeBase


def _ramp(dist, width):
    """Normalized tanh ramp: 0 at dist<=0 rising to 1 over ~4*width."""
    w0 = 0.5 * (np.tanh(-2.0) + 1.0)
    w = 0.5 * (np.tanh(dist / width - 2.0) + 1.0)
    return np.maximum((w - w0) / (1.0 - w0), 0.0)


@dataclass
class PlaneSponge:
    point: tuple
    normal: tuple
    width: float
    mult: float


@dataclass
class CylinderSponge:
    # one positive radius selects the cylinder axis (X, Y, or Z); distance is
    # measured from that axis (reference: spongeCylinder)
    radius_x: float = -1.0
    radius_y: float = -1.0
    radius_z: float = -1.0
    point: tuple = (0.0, 0.0, 0.0)
    width: float = 1e-8
    mult: float = 1.0


@dataclass
class AnnulusSponge:
    # y-axis-aligned torus ring of major radius radius_y at height point[1]
    # with minor width `width` (reference: spongeAnnulus)
    point: tuple = (0.0, 0.0, 0.0)
    radius_y: float = -1.0
    width: float = 1e-8
    mult: float = 1.0


class GeometricSponge(SpongeBase):
    def __init__(self, tab, uniform_mult=None, plane=None, cylinder=None,
                 annulus=None):
        xyz = h1._np(tab.xyz)
        nd, dim = xyz.shape
        wgt = np.ones(nd)

        if uniform_mult is not None:
            wgt = np.maximum(wgt, max(float(uniform_mult), 1.0))

        if plane is not None:
            n = np.asarray(plane.normal, float)[:dim]
            p = np.asarray(plane.point, float)[:dim]
            dist = (xyz - p) @ n
            w = _ramp(dist, plane.width) * (max(plane.mult, 1.0) - 1.0) + 1.0
            wgt = np.maximum(wgt, w)

        if cylinder is not None:
            c = cylinder
            x = xyz - np.asarray(c.point, float)[:dim]
            for axis, rad in ((0, c.radius_x), (1, c.radius_y), (2, c.radius_z)):
                if rad > 0.0:
                    others = [d for d in range(dim) if d != axis]
                    dist = np.sqrt(np.sum(x[:, others] ** 2, axis=1)) - rad
                    w = _ramp(dist, c.width) * (max(c.mult, 1.0) - 1.0) + 1.0
                    wgt = np.maximum(wgt, w)
                    break

        if annulus is not None and dim == 3:
            a = annulus
            rad1, rad2 = a.radius_y, a.width
            dist1 = np.sqrt(xyz[:, 0] ** 2 + xyz[:, 2] ** 2)
            s = (rad1 / np.maximum(dist1, 1e-300))[:, None] * xyz
            s[:, 1] = a.point[1]
            dist2 = np.linalg.norm(xyz - s, axis=1)
            w0 = 0.5 * (np.tanh(-2.0) + 1.0)
            w = 0.5 * (np.tanh(10.0 * (1.0 - dist2 / rad2)) + 1.0)
            w = np.maximum((w - w0) / (1.0 - w0), 0.0)
            w = w * (max(a.mult, 1.0) - 1.0) + 1.0
            wgt = np.maximum(wgt, w)

        self._mult = torch.as_tensor(wgt, dtype=tab.wq.dtype,
                                     device=tab.wq.device)

    def multiplier(self):
        return self._mult
