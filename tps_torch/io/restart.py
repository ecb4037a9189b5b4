"""Checkpoint and restart on one device, in the JAX package's file layout.

The JAX package's io/restart.py (tps_tpu/io/restart.py:17-67, 173-414,
525), single device, through io/h5lite.py instead of h5py.  Mirrors the
reference restart organizer (src/io.cpp, src/io.hpp:85-274): the
conserved state by equation name under /solution, one flat dof-major
dataset per equation, and the run's metadata as root attributes
(iteration, time, dt, order, nprocs, ne_global, dofs_global).  h5py and
the JAX package read what this writes, and this reads theirs.

Not here: the running statistics a checkpoint may carry (/meanSolution,
/rmsData) are skipped on read, as the JAX package skips them with
averaging off (averaging is ROADMAP A12); the per-shard layout
(write_partitioned / read_partitioned) is ROADMAP A8.
"""

from __future__ import annotations

import os

import numpy as np

from . import h5lite


def _state_field_names(mixture, species_names=None):
    """Equation names, the reference's (registerIOVar, src/M2ulPhyS.cpp:
    1843): density, x-/y-/z-mom, rho-E, rho-Y_<species>, rhoE_e."""
    names = ["density"] + ["x-mom", "y-mom", "z-mom"][: mixture.nvel]
    names.append("rho-E")
    for s in range(mixture.num_active_species):
        names.append(f"rho-Y_{species_names[s] if species_names else s}")
    if mixture.two_temperature:
        names.append("rhoE_e")
    return names


def _solver_field_names(solver):
    plasma = getattr(solver, "plasma", None)
    return _state_field_names(
        solver.mixture, None if plasma is None else plasma.species_names)


def _field_aliases(solver):
    """Alternate dataset spellings: named species fields also accept the
    indexed 'rho-Y_<k>' form and vice versa."""
    named = _solver_field_names(solver)
    indexed = _state_field_names(solver.mixture)
    return {a: [b] for a, b in zip(named, indexed) if a != b}


def _read_field(group, name, aliases, optional, shape):
    """One /solution dataset, under its name or an alias; an `optional`
    field that is absent reads as zeros."""
    if name in group:
        return np.asarray(group[name]).reshape(shape)
    for alias in aliases.get(name, ()):
        if alias in group:
            return np.asarray(group[alias]).reshape(shape)
    if name in optional:
        return np.zeros(shape)
    raise KeyError(f"restart file is missing /solution/{name}")


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


class RestartIO:
    """Write and read restart files for a solver with state_global(),
    set_state_global(), set_time(), iter, time, dt."""

    def __init__(self, config):
        self.config = config

    @property
    def outdir(self):
        return self.config.outdir

    def path(self):
        os.makedirs(self.outdir, exist_ok=True)
        return os.path.join(self.outdir, "restart_output.sol.h5")

    def write(self, solver, path=None):
        """Write a checkpoint (with `path`, under that exact name)."""
        names = _solver_field_names(solver)
        U = np.asarray(solver.state_global())
        attrs = {"iteration": int(solver.iter), "time": float(solver.time),
                 "dt": float(solver.dt), "order": int(solver.config.order),
                 "nprocs": 1, "ne_global": U.shape[0],
                 "dofs_global": U.shape[0] * U.shape[1]}
        # dof-major flat layout, like the reference's GridFunctions
        sol = {name: U[:, :, k].reshape(-1) for k, name in enumerate(names)}
        if path is None:
            path = self.path()
        elif os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        h5lite.write(path, {"solution": sol}, attrs)

    def read(self, solver, path=None):
        """Read a checkpoint into `solver` (with `path`, that exact file)."""
        names = _solver_field_names(solver)
        aliases = _field_aliases(solver)
        optional = frozenset(getattr(solver, "_restart_optional_fields", ()))
        explicit = path is not None
        if not explicit:
            path = self.path()
            shards = os.path.exists(
                os.path.join(self.outdir, "restart_output.sol.0.h5"))
            if shards and self.config.restart_mode not in (
                    "singleFileRead", "singleFileReadWrite"):
                raise _not_ported("the per-shard restart layout", "A8")
        if not os.path.exists(path):
            raise FileNotFoundError(f"restart file not found: {path}")
        f = h5lite.read(path)
        ne = int(solver.ne_global)
        # refuse a checkpoint of another mesh (the reference validates
        # dofs_global / order, test/cyl3d.test:38-51)
        if "ne_global" in f.attrs and int(f.attrs["ne_global"]) != ne:
            raise ValueError(
                f"restart mesh mismatch: file has {int(f.attrs['ne_global'])}"
                f" elements, current mesh has {ne}")
        stored_order = int(f.attrs.get("order", solver.config.order))
        g = f["solution"]
        rho = _read_field(g, names[0], aliases, optional, (ne, -1))
        cols = [rho] + [_read_field(g, name, aliases, optional,
                                    (ne, rho.shape[1]))
                        for name in names[1:]]
        U = np.stack(cols, axis=-1)
        if stored_order != solver.config.order:
            # variable-order restart (reference [io]/restartMode variableP,
            # IOFamily::readChangeOrder src/io.hpp:219)
            U = _resample_order(
                U, solver.mesh.geom, stored_order, solver.config.order,
                "gauss-legendre" if solver.config.basis_type == 0
                else "gauss-lobatto")
        solver.iter = int(f.attrs["iteration"])
        solver.set_time(float(f.attrs["time"]), float(f.attrs["dt"]))
        solver.set_state_global(U)
        return solver


def _resample_order(U, geom, order_from, order_to, basis):
    """Per-element nodal resampling between polynomial orders, U [ne,
    ndof_from, neq] -> [ne, ndof_to, neq]: interpolation (exact when
    raising the order, collocation when lowering it)."""
    from ..mesh.reference_element import ReferenceElement

    ref_from = ReferenceElement(geom=geom, order=order_from, basis=basis)
    ref_to = ReferenceElement(geom=geom, order=order_to, basis=basis)
    R = ref_from.eval_basis(ref_to.nodes)  # [ndof_to, ndof_from]
    return np.einsum("td,ndk->ntk", R, U)
