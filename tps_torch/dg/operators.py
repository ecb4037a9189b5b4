"""Single-device DG operators of the general (slot) path, on torch tensors.

The JAX package's dg/operators.py, carried over function by function with
the same names and formulas: trace interpolation through the oriented
trace rows (Btr_or), the neighbor-slot face views, weak divergence,
inverse mass and the DG gradient.  Every operator is a kron(B, I_k)
matmul on the fused [ne, ndof*k] layout, as in the JAX package.  Also
the interior face sweep of its dg/rhs.py:143-178 (`face_sweep_plain`),
the plain version of dg/cuda_faces.py's kernel.

Left out here: `halo_exchange` and the legacy face_gather /
face_scatter_gather branch (sharded tables, ROADMAP A8), and the
boundary jump of the gradient (`bdr_up2`, useBCinGrad, ROADMAP A5.2).

The kron-expanded matrices are constants of the tables.  The JAX package
builds them inside jit, where XLA folds them once; eager PyTorch would
rebuild them on every call, so `_const` keeps them on the tables object.
"""

from __future__ import annotations

import torch


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported to tps_torch yet "
                               f"(ROADMAP {item})")


def _const(tab, key, like, build):
    """A per-table constant of X's dtype and device, built once."""
    cache = tab.__dict__.setdefault("_op_cache", {})
    key = key + (like.dtype, like.device)
    if key not in cache:
        cache[key] = build().to(dtype=like.dtype, device=like.device)
    return cache[key]


def _trace_kron(tab, c, k, like):
    """kron(Btr_or[combo c], I_k): [ndof*k, nqf*k] (X2 @ K = trace)."""
    def build():
        nqf = tab.nqf
        B = tab.Btr_or[c * nqf : (c + 1) * nqf]  # [nqf, ndof]
        eye = torch.eye(k, dtype=B.dtype, device=B.device)
        return torch.einsum("sd,ef->desf", B, eye).reshape(-1, nqf * k)
    return _const(tab, ("trace", c, k), like, build)


def _scatter_kron(tab, lf, k, like):
    """kron(Btr[lf]^T, I_k): [nqf*k, ndof*k] (face points -> dofs)."""
    def build():
        nqf = tab.nqf
        B = tab.Btr[lf * nqf : (lf + 1) * nqf]  # [nqf, ndof]
        eye = torch.eye(k, dtype=B.dtype, device=B.device)
        return torch.einsum("sj,ef->sejf", B, eye).reshape(nqf * k, -1)
    return _const(tab, ("scatter", lf, k), like, build)


def elem_traces(tab, X):
    """X [ne, ndof, k] -> [ne, nlf*nqf, k] on every local face."""
    return torch.einsum("fd,ndk->nfk", tab.Btr, X)


def elem_traces_or(tab, X):
    """Oriented traces: X [ne, ndof, k] -> [ne, n_combo*nqf, k]."""
    return torch.einsum("fd,ndk->nfk", tab.Btr_or, X)


def _roll(A, grid, axis, shift):
    """Grid roll of a per-element buffer [ne, ...] over the element grid."""
    Ag = A.reshape(tuple(grid) + tuple(A.shape[1:]))
    return torch.roll(Ag, shifts=shift, dims=axis).reshape(A.shape)


def slot_traces(tab, X):
    """(own, nbr) [ne, nlf, nqf, k] oriented traces of every slot: own is
    the identity combos, nbr a grid roll of the opposite face's trace
    (structured meshes) or one row gather through nbr_row."""
    ne, _, k = X.shape
    Xtr = elem_traces_or(tab, X)
    own = Xtr[:, : tab.nlf * tab.nqf, :].reshape(ne, tab.nlf, tab.nqf, k)
    if tab.roll_info is not None:
        grid, per_lf = tab.roll_info
        nbr = torch.stack([_roll(own[:, opp], grid, axis, shift)
                           for (axis, shift, opp) in per_lf], dim=1)
        return own, nbr
    flat = Xtr.reshape(ne * tab.n_combo, tab.nqf, k)
    nbr = flat[tab.nbr_row.reshape(-1).long()].reshape(ne, tab.nlf, tab.nqf, k)
    return own, nbr


def perface_own_traces(tab, X):
    """Own-side per-face trace buffers: tuple of nlf [ne, nqf*k]."""
    ne, ndof, k = X.shape
    X2 = X.reshape(ne, ndof * k)
    return tuple(X2 @ _trace_kron(tab, lf, k, X) for lf in range(tab.nlf))


def perface_traces(tab, X):
    """Per-face trace buffers and their neighbors (the face sweep's inputs).

    X [ne, ndof, k] -> (own, nbr): tuples of nlf [ne, nqf*k].  nbr[lf] is
    a grid roll of the opposite face's buffer (structured meshes) or one
    row gather over the stacked per-combo oriented traces."""
    ne, ndof, k = X.shape
    nqf, nlf, nc = tab.nqf, tab.nlf, tab.n_combo
    X2 = X.reshape(ne, ndof * k)
    T_c = [X2 @ _trace_kron(tab, c, k, X) for c in range(nc)]
    own = tuple(T_c[:nlf])
    if tab.roll_info is not None:
        grid, per_lf = tab.roll_info
        nbr = tuple(_roll(own[opp], grid, axis, shift)
                    for (axis, shift, opp) in per_lf)
        return own, nbr
    flat = torch.stack(T_c, dim=1).reshape(ne * nc, nqf * k)
    rows = tab.nbr_row.long()
    nbr = tuple(flat[rows[:, lf]] for lf in range(nlf))
    return own, nbr


def trace_transpose(tab, Fel):
    """Fel [ne, nlf*nqf, k] -> [ne, ndof, k]: the B_tr^T apply."""
    return torch.einsum("fd,nfk->ndk", tab.Btr, Fel)


def _adjj_rep(tab, neq):
    """adjJ with each quad value repeated neq times: [dim, dim, ne, nq*neq]."""
    a = tab.adjJ.permute(2, 3, 0, 1)  # [k, d, ne, nq]
    a = a[..., None].expand(a.shape + (neq,))
    return a.reshape(tab.dim, tab.dim, tab.adjJ.shape[0], tab.nq * neq)


def volume_weak_div(tab, Fdof, fused_out=False):
    """Volume term sum_q w_q grad(phi_i) . F, F at the solution nodes.

    Fdof: [ne, ndof, neq, dim] -> z [ne, ndof, neq] (or [ne, ndof*neq])."""
    ne, ndof, neq, dim = Fdof.shape
    nq = tab.nq

    def k_b():
        eye = torch.eye(neq, dtype=tab.Bvol.dtype, device=tab.Bvol.device)
        return torch.einsum("qd,ef->deqf", tab.Bvol, eye).reshape(
            ndof * neq, nq * neq)

    def k_gw(kk):
        def build():
            eye = torch.eye(neq, dtype=tab.wq.dtype, device=tab.wq.device)
            return torch.einsum("q,qj,ef->qfje", tab.wq, tab.Gvol[:, :, kk],
                                eye).reshape(nq * neq, ndof * neq)
        return build

    K_b = _const(tab, ("vol_b", neq), Fdof, k_b)
    Fq_d = [Fdof[..., d].reshape(ne, ndof * neq) @ K_b for d in range(dim)]
    arep = _const(tab, ("adjj_rep", neq), Fdof, lambda: _adjj_rep(tab, neq))
    rad = None
    if tab.rad_vol is not None:  # axisymmetric: dV = r dr dz
        rad = tab.rad_vol[..., None].expand(ne, nq, neq).reshape(ne, nq * neq)
    z2 = 0.0
    for kk in range(dim):
        Fk = sum(Fq_d[d] * arep[kk, d] for d in range(dim))
        if rad is not None:
            Fk = Fk * rad
        z2 = z2 + Fk @ _const(tab, ("vol_gw", kk, neq), Fdof, k_gw(kk))
    if fused_out:
        return z2
    return z2.reshape(ne, ndof, neq)


def apply_minv(tab, Z, radial=False):
    """Element-wise inverse mass: [ne, ndof, k] -> [ne, ndof, k].

    A diagonal mass (affine elements, collocated GL basis) is one
    multiply; otherwise (the Gauss-Lobatto basis) a batched matmul."""
    use_rad = radial and tab.Minv_rad is not None
    d = getattr(tab, "minv_rad_diag" if use_rad else "minv_diag", None)
    if d is not None:
        return Z * d[..., None]
    M = tab.Minv_rad if use_rad else tab.Minv
    return torch.einsum("nij,njk->nik", M, Z)


def apply_minv2(tab, Z2, k, radial=False):
    """Inverse mass on the fused layout: [ne, ndof*k] -> [ne, ndof*k]."""
    ne = Z2.shape[0]
    ndof = tab.Minv.shape[-1]
    return apply_minv(tab, Z2.reshape(ne, ndof, k), radial).reshape(ne, -1)


def dg_gradient(tab, Up, bdr_up2=None):
    """DG gradient of the primitives with central face fluxes.

    gradUp = M^-1 [ int phi grad(u) dx + oint phi (mean - u^-) n ds ]
    (reference: src/gradients.cpp:144-232, faceGradientIntegration.cpp)

    Up: [ne, ndof, neq] -> gradUp [ne, ndof, neq, dim].  Boundary slots
    carry no jump (interior_mask)."""
    if bdr_up2 is not None:
        raise _not_ported("boundary states in the gradient (useBCinGrad)",
                          "A5.2")
    if tab.nbr_row is None:
        raise _not_ported("the gradient on sharded (legacy) tables", "A8")
    ne, ndof, neq = Up.shape
    dim, nq, nqf = tab.dim, tab.nq, tab.nqf

    def k_grad(d):
        def build():
            eye = torch.eye(neq, dtype=tab.Gvol.dtype, device=tab.Gvol.device)
            return torch.einsum("qd,ef->deqf", tab.Gvol[:, :, d], eye).reshape(
                ndof * neq, nq * neq)
        return build

    def k_bw():
        eye = torch.eye(neq, dtype=tab.wq.dtype, device=tab.wq.device)
        return torch.einsum("q,qj,ef->qfje", tab.wq, tab.Bvol, eye).reshape(
            nq * neq, ndof * neq)

    # volume: int phi_j du/dx_kk = sum_q w_q B[q,j] sum_d (G_d u) adjJ[d,kk]
    up2 = Up.reshape(ne, ndof * neq)
    du_d = [up2 @ _const(tab, ("grad_g", d, neq), Up, k_grad(d))
            for d in range(dim)]
    arep = _const(tab, ("adjj_rep", neq), Up, lambda: _adjj_rep(tab, neq))
    K_bw = _const(tab, ("grad_bw", neq), Up, k_bw)
    rvol = torch.stack(
        [sum(du_d[d] * arep[d, kk] for d in range(dim)) @ K_bw
         for kk in range(dim)], dim=-1).reshape(ne, ndof, neq, dim)

    # faces: per slot, (mean - u_own) . n_out in the slot's own ordering
    own_pf, nbr_pf = perface_traces(tab, Up)
    norw = tab.nor_slot * tab.wts_slot[..., None]  # [ne, nlf, nqf, dim]
    rface_d = [0.0] * dim
    for lf in range(tab.nlf):
        jump = 0.5 * (nbr_pf[lf] - own_pf[lf]) * tab.interior_mask[:, lf, None]
        K_out = _scatter_kron(tab, lf, neq, Up)
        for d in range(dim):
            nw = norw[:, lf, :, d, None].expand(ne, nqf, neq).reshape(
                ne, nqf * neq)
            rface_d[d] = rface_d[d] + (jump * nw) @ K_out
    rface = torch.stack(rface_d, dim=-1).reshape(ne, ndof, neq, dim)
    rhs = rvol + rface
    return apply_minv(tab, rhs.reshape(ne, ndof, neq * dim)).reshape(
        ne, ndof, neq, dim)


def _clip_species(mix, U):
    """max(rho Y_s, 0) as the reference does at interpolated states
    (src/face_integrator.cpp:296-301, src/rhs_operator.cpp:513-517)."""
    nact = mix.num_active_species
    if nact == 0:
        return U
    lo, hi = mix.nvel + 2, mix.nvel + 2 + nact
    return torch.cat([U[..., :lo], torch.clamp(U[..., lo:hi], min=0.0),
                      U[..., hi:]], dim=-1)


def face_sweep_plain(ctx, tab, X):
    """The slot path's interior face sweep in plain PyTorch, the JAX
    package's dg/rhs.py:143-178: per local face the Riemann flux minus the
    mean one-sided viscous normal flux, masked to interior slots and
    scattered through Btr_lf^T.  X = [U | G] [ne, ndof, k] -> minus that
    sum, [ne, ndof, neq] (the face term's sign, before the boundary slots
    and the inverse mass).  The plain version of dg/cuda_faces.py's
    kernel in slot mode."""
    mix = ctx.mixture
    neq, dim = mix.num_equations, tab.dim
    ne, ndof, _k = X.shape
    nqf = tab.nqf
    viscous = ctx.fluxes.eq_system != "euler"
    own_pf, nbr_pf = perface_traces(tab, X)

    def split(Z2):
        Z = Z2.reshape(ne, nqf, -1)
        Uz = _clip_species(mix, Z[..., :neq])
        gz = Z[..., neq:].reshape(ne, nqf, neq, dim) if viscous else None
        return Uz, gz

    z2 = torch.zeros((ne, ndof * neq), dtype=X.dtype, device=X.device)
    for lf in range(tab.nlf):
        U1, g1 = split(own_pf[lf])
        U2, g2 = split(nbr_pf[lf])
        # weights are folded into the normals (nor_wpf); the flux is
        # degree-1 homogeneous in the scaled normal
        nor = tab.nor_wpf[lf].reshape(ne, nqf, dim)
        flux = ctx.riemann(U1, U2, nor)
        if viscous:
            xyz = tab.xyz_slot[:, lf]
            dist = None if tab.dist_slot is None else tab.dist_slot[:, lf]
            Fv1 = ctx.fluxes.viscous(U1, mix.primitives(U1), g1, xyz=xyz,
                                     delta=tab.delta[:, None, None],
                                     distance=dist)
            Fv2 = ctx.fluxes.viscous(U2, mix.primitives(U2), g2, xyz=xyz,
                                     delta=tab.delta_nbr[:, lf, None, None],
                                     distance=dist)
            flux = flux - torch.einsum("...ed,...d->...e", 0.5 * (Fv1 + Fv2),
                                       nor)
        flux = flux * tab.interior_mask[:, lf, None, None]
        z2 = z2 + flux.reshape(ne, nqf * neq) @ _scatter_kron(tab, lf, neq, X)
    return (-z2).reshape(ne, ndof, neq)
