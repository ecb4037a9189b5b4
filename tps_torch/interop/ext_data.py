"""External-data interpolation (Gaussian kernel) for inlet profiles and
volume field initialisation.

The port of the JAX package's interop/ext_data.py (the role of the
reference GaussianInterpExtData, src/gaussianInterpExtData.cpp), all four
field modes:

- inlet plane (`setInlet` :268): CSV columns index, x, y, z, T, u, v, w
  [, Y_1..Y_ns]; points with T < 0 are outside the source domain and
  excluded; velocity (and axisymmetric swirl = w) ramps over `rampSteps`
  time steps (`step` :1098).
- inlet turbulence scalars for the zeta-f RANS model
  (`setInletTurbScalars` :910): rows x y z tke v2, scaled by
  `ransModel/bc-fac`.
- frozen volume eddy viscosity for static-rans (`setFieldTurbVisc` :750):
  rows x y z nu_t, scaled by `loMach/static-rans/visc-fac`.
- volume species initialisation (`setFieldInitSpec` :559): rows
  x y z Y_1..Y_n (`plasma_models/initialize_file`).

All use the same adaptive Gaussian kernel: radius = second-nearest source
distance, weights exp(-d^2/r^2) cut at 1.5 r.  The readers and the
interpolation are numpy at set-up.  The inlet's ramp is device state: a
step counter the low-Mach step advances (`step`), so a step that runs it
stays capturable as a CUDA graph (the JAX package keeps the count on the
host and so steps such a deck one step at a time).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem import h1

_CHUNK = 2048  # destination points per block of the interpolation


def read_profile(path):
    """Generic numeric-row reader: whitespace- or comma-separated columns,
    non-numeric (header) lines skipped.  Returns [m, ncols]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line:
                continue
            try:
                rows.append([float(t) for t in line.split()])
            except ValueError:
                continue
    if not rows:
        raise ValueError(f"{path}: no numeric rows")
    ncols = len(rows[0])
    if any(len(r) != ncols for r in rows):
        raise ValueError(f"{path}: inconsistent column counts")
    return np.asarray(rows, dtype=np.float64)


def read_inlet_plane(path):
    """CSV -> (xyz [m, 3], T [m], vel [m, 3], Y [m, ns])."""
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    xyz = data[:, 1:4]
    T = data[:, 4]
    vel = data[:, 5:8]
    Y = data[:, 8:]
    keep = T >= 0.0
    return xyz[keep], T[keep], vel[keep], Y[keep]


def gaussian_interp(src_xyz, src_vals, dst_xyz):
    """Adaptive-radius Gaussian interpolation (numpy, setup-time).

    src_vals: [m, k] -> returns [n, k].
    """
    src_xyz = np.asarray(src_xyz, dtype=np.float64)
    src_vals = np.atleast_2d(np.asarray(src_vals, dtype=np.float64))
    if src_vals.shape[0] != src_xyz.shape[0]:
        src_vals = src_vals.T
    dst_xyz = np.asarray(dst_xyz, dtype=np.float64)
    n = dst_xyz.shape[0]
    out = np.zeros((n, src_vals.shape[1]))
    for i0 in range(0, n, _CHUNK):
        d = np.linalg.norm(
            dst_xyz[i0 : i0 + _CHUNK, None, :3] - src_xyz[None, :, :3], axis=-1
        )  # [c, m]
        dsort = np.sort(d, axis=1)
        radius = dsort[:, 1] if d.shape[1] > 1 else dsort[:, 0]
        radius = np.maximum(radius, 1e-14)
        w = np.exp(-(d**2) / radius[:, None] ** 2)
        w = np.where(d <= 1.5 * radius[:, None], w, 0.0)
        wtot = w.sum(axis=1)
        # fall back to nearest neighbor where the cutoff excluded everything
        nearest = src_vals[np.argmin(d, axis=1)]
        vals = w @ src_vals
        out[i0 : i0 + _CHUNK] = np.where(
            wtot[:, None] > 0.0, vals / np.maximum(wtot, 1e-300)[:, None], nearest
        )
    return out


def _pad3(xyz):
    """Pad 2-D coordinates with a zero z column."""
    xyz = np.asarray(xyz, dtype=np.float64)
    if xyz.shape[1] < 3:
        xyz = np.concatenate(
            [xyz, np.zeros((len(xyz), 3 - xyz.shape[1]))], axis=1)
    return xyz


def volume_field_from_file(tab, fname, fac=1.0):
    """Interpolate a volume profile file (rows x y z val...) onto every H1
    dof.  Returns [ndofs, nval] (squeezed to [ndofs] for one column).
    Reference: setFieldTurbVisc / setFieldInitSpec
    (src/gaussianInterpExtData.cpp:559-908)."""
    data = read_profile(fname)
    vals = gaussian_interp(data[:, :3], data[:, 3:], _pad3(h1._np(tab.xyz)))
    vals = vals * fac
    return vals[:, 0] if vals.shape[1] == 1 else vals


def inlet_scalars_from_file(tab, fname, attrs, fac=1.0):
    """Interpolate an inlet profile file (rows x y z val...) onto the
    boundary dofs of `attrs`.  Returns (dofs [m], vals [m, nval]).
    Reference: setInletTurbScalars (src/gaussianInterpExtData.cpp:910-1096,
    tke/v2 scaled by ransModel/bc-fac)."""
    data = read_profile(fname)
    dofs = np.asarray(h1.boundary_dofs(tab, tuple(attrs)))
    xyz = _pad3(h1._np(tab.xyz)[dofs])
    vals = gaussian_interp(data[:, :3], data[:, 3:], xyz) * fac
    return dofs, vals


class GaussianInterpExtData:
    """Interpolated inlet data for the low-Mach path, with time ramping
    (reference: rampSteps, src/gaussianInterpExtData.cpp:78).  The values
    at the inlet dofs (`dofs`, a device index) are tensors; `count` is the
    device step counter `step` advances, `ramp` = min(count / rampSteps,
    1)."""

    def __init__(self, tab, fname, inlet_attrs, ramp_steps=1):
        kw = {"dtype": tab.wq.dtype, "device": tab.wq.device}
        self.ramp_steps = max(int(ramp_steps), 1)
        self.count = torch.zeros((), **kw)

        dofs = np.asarray(h1.boundary_dofs(tab, tuple(inlet_attrs)))
        self.dofs = torch.as_tensor(dofs.astype(np.int64),
                                    device=tab.wq.device)
        xyz = _pad3(h1._np(tab.xyz)[dofs])
        src_xyz, T, vel, _Y = read_inlet_plane(fname)
        vals = gaussian_interp(src_xyz, np.column_stack([vel, T]), xyz)
        self.velocity_bdr = torch.as_tensor(vals[:, : tab.dim], **kw)
        # axisymmetric (r, z) meshes: the w column is the swirl component
        # (reference: swirl_gf_, src/gaussianInterpExtData.cpp:1124-1131)
        self.swirl_bdr = (torch.as_tensor(vals[:, 2], **kw)
                          if tab.dim == 2 else None)
        self.temperature_bdr = torch.as_tensor(vals[:, 3], **kw)

    @property
    def ramp(self):
        return torch.clamp(self.count / self.ramp_steps, max=1.0)

    def step(self):
        self.count.add_(1.0)

    def velocity_values(self):
        return self.velocity_bdr * self.ramp

    def swirl_values(self):
        """Ramped swirl (u_theta) for axisymmetric inlets; None in 3-D."""
        return None if self.swirl_bdr is None else self.swirl_bdr * self.ramp

    def temperature_values(self):
        return self.temperature_bdr
