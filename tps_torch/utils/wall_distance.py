"""Wall-distance fields, computed once at set-up in numpy.

The port's copy of the JAX package's utils/wall_distance.py, in the role
of the reference's serial distance function (src/utils.hpp:152
evaluateDistanceSerial, read by the mixing-length transport): the
distance from each point to the nearest quadrature point of a wall face,
exact to the sampled wall points, vectorised in chunks.
"""

from __future__ import annotations

import numpy as np


def wall_face_points(tab_np, wall_attrs) -> np.ndarray:
    """[nw, dim] quadrature points of the boundary faces whose attribute
    is in wall_attrs (reference: the wall_patch_list of
    src/M2ulPhyS.cpp:393-398, every wall patch that is not inviscid)."""
    attrs = np.asarray(tab_np.f_bdr_attr)
    sel = np.isin(attrs, list(wall_attrs))
    if not sel.any():
        return np.zeros((0, tab_np.dim))
    return np.asarray(tab_np.f_xyz)[tab_np.nfi:][sel].reshape(-1, tab_np.dim)


def distance_to_points(points, wall_pts, chunk=4096) -> np.ndarray:
    """Euclidean distance from each row of `points` [..., dim] to the
    nearest wall point; inf where there is no wall point."""
    pts = np.asarray(points, dtype=np.float64)
    shape = pts.shape[:-1]
    pts = pts.reshape(-1, pts.shape[-1])
    if len(wall_pts) == 0:
        return np.full(shape, np.inf)
    out = np.empty(len(pts))
    for s in range(0, len(pts), chunk):
        d2 = np.sum((pts[s:s + chunk, None, :] - wall_pts[None, :, :]) ** 2,
                    axis=-1)
        out[s:s + chunk] = np.sqrt(d2.min(axis=1))
    return out.reshape(shape)


def wall_distance(tab_np, wall_attrs, chunk=4096) -> np.ndarray:
    """distance [ne, ndof] from the solution nodes to the nearest
    wall-face quadrature point."""
    wall_pts = wall_face_points(tab_np, wall_attrs)
    return distance_to_points(tab_np.xyz_dof, wall_pts, chunk=chunk)
