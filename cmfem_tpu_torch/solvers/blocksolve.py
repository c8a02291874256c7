"""Device solves for the 2x2 (T, p) block Jacobians of the ablation Newton.

Port of ``cmfem_tpu/solvers/blocksolve.py`` (the reference solves these
systems with MUMPS LU).  The Jacobian stays in the element-block form of
``AblationSystem.element_jacobians`` and the solve runs on the device:

- **symmetric diagonal equilibration**: the raw (T, p) system spans ~9
  orders of magnitude between the T and p rows, which stalls any Krylov
  method in the unscaled norm; it is rescaled once per Jacobian rebuild as
  S J S y = S b, x = S y with S = diag(1/sqrt(|diag J|));
- **2x2 point-block preconditioning**: the (T_i, p_i) diagonal coupling
  pair of every dof is inverted in closed form;
- the operator apply is a batched (ne, 2nd, 2nd) matvec plus an
  ``index_add_`` scatter, or on a strip dof lattice a stencil (DIA) matvec
  of shifted windows;
- the outer solve is the port's restarted GMRES (``solvers.krylov``);
- on a strip lattice ``pc="linemg"`` replaces the point-block factors by the
  x-semicoarsened line multigrid of ``solvers.linemg``, whose iteration
  count does not grow with refinement.

``BlockTridiagDirect`` factors the order-1 strip's block-tridiagonal
system by a block-QR elimination down the y levels and uses the banded
solve as GMRES's left preconditioner.  The JAX package runs its level
recurrences as ``lax.scan``s; here they are Python loops over tensors on
the device (``torch.linalg.qr``, ``torch.linalg.solve_triangular``).
cuSOLVER and LAPACK may choose other signs for Q and R: compare solutions,
never factors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lattice2d import StripLatticeOps, cluster_x_columns
from .krylov import gmres
from .linemg import StripLineMG


def strip_dof_lattice(positions, tol_factor=1e-8):
    """Recover an (NY, NX) dof lattice from scalar-dof positions of a
    tensor-product strip mesh.  Columns are tolerance-clustered on x (GMSH
    emits float jitter); each column must hold the same number of dofs,
    sorted by y.  Raises ValueError when the dofs are not a tensor-product
    lattice."""
    pos = np.asarray(positions)
    if pos.ndim != 2 or pos.shape[1] < 2:
        raise ValueError("strip_dof_lattice needs (n, >=2) positions")
    xy = pos[:, :2]
    n = len(xy)
    col_of, nx = cluster_x_columns(xy[:, 0], tol_factor)
    if n % nx:
        raise ValueError("dofs do not tile an x-column lattice")
    ny = n // nx
    lat = np.full((ny, nx), -1, dtype=np.int64)
    for c in range(nx):
        ids = np.nonzero(col_of == c)[0]
        if len(ids) != ny:
            raise ValueError("unequal column heights in dof lattice")
        lat[:, c] = ids[np.argsort(xy[ids, 1], kind="stable")]
    return lat


def equilibrated_block_factors(Je, lmask, mask2, gather, scatter, nd, n,
                               reduce_fn=lambda x: x):
    """BC-eliminate and equilibrate (2nd, 2nd) element blocks; build the
    2x2 point-block preconditioner.

    Returns (Je_s, pb, s): scaled blocks (the matvec), the per-dof inverse
    2x2 coupling factors (the preconditioner), and the equilibration
    vector s (2n,)."""
    dtype = Je.dtype
    lm = lmask.to(dtype)                        # (nel, 2nd)
    keep = 1.0 - lm
    eye = torch.eye(2 * nd, dtype=dtype, device=Je.device)
    Je_bc = Je * keep[:, :, None] * keep[:, None, :] \
        + eye[None] * lm[:, :, None]
    # global diagonal -> symmetric equilibration S J S
    tiny = torch.finfo(dtype).tiny
    diag_e = torch.diagonal(Je_bc, dim1=1, dim2=2)
    dvec = reduce_fn(scatter(diag_e))
    s = torch.where(mask2, 1.0,
                    1.0 / torch.sqrt(torch.clamp(torch.abs(dvec), min=tiny)))
    s_e = gather(s)
    Je_s = Je_bc * s_e[:, :, None] * s_e[:, None, :]
    # 2x2 point-block PC: per-dof scaled [[dTT, dTp], [dpT, dpp]]
    # (off-diagonal pairs gathered from the (i_T, i_p) block entries)
    idx = torch.arange(nd, device=Je.device)
    dTp_e = Je_s[:, idx, nd + idx]              # (nel, nd)
    dpT_e = Je_s[:, nd + idx, idx]
    dJ = reduce_fn(scatter(torch.diagonal(Je_s, dim1=1, dim2=2)))
    half = torch.zeros((dTp_e.shape[0], nd), dtype=dtype, device=Je.device)
    seg_T = lambda v: reduce_fn(scatter(torch.cat([v, half], dim=1)))[:n]
    dTT = torch.where(mask2[:n], 1.0, dJ[:n])
    dpp = torch.where(mask2[n:], 1.0, dJ[n:])
    off_mask = mask2[:n] | mask2[n:]
    dTp = torch.where(off_mask, 0.0, seg_T(dTp_e))
    dpT = torch.where(off_mask, 0.0, seg_T(dpT_e))
    det = dTT * dpp - dTp * dpT
    det = torch.where(torch.abs(det) > tiny, det, 1.0)
    pb = torch.stack([dpp / det, -dTp / det, -dpT / det, dTT / det])
    return Je_s, pb, s


def solve_equilibrated(matvec, pb, s, b, mask2, n, rtol, atol,
                       restart, maxiter):
    """GMRES on the equilibrated system with the 2x2 point-block PC;
    ``matvec`` applies the scaled blocks (without the essential-identity
    rows, which are pinned here).  Returns a SolveResult with x unscaled."""

    def apply_A(y):
        return torch.where(mask2, y, matvec(y))

    def M(r):
        rT, rp = r[:n], r[n:]
        return torch.cat([pb[0] * rT + pb[1] * rp, pb[2] * rT + pb[3] * rp])

    res = gmres(apply_A, s * b, M=M, rtol=rtol, atol=atol,
                restart=restart, maxiter=maxiter)
    return res._replace(x=s * res.x)


def _shift_windows(S, y, L, n):
    """The stencil (DIA) matvec: y[f] = sum_g sum_off S[f,g,off] *
    shift(x[g], off), as padded shifted-window multiplies."""
    NY, NX, pad = L["NY"], L["NX"], L["pad"]
    xT = torch.nn.functional.pad(y[:n].reshape(NY, NX), (pad,) * 4)
    xp = torch.nn.functional.pad(y[n:].reshape(NY, NX), (pad,) * 4)
    yT = torch.zeros((NY, NX), dtype=y.dtype, device=y.device)
    yp = torch.zeros_like(yT)
    for k, (oy, ox) in enumerate(L["offs"]):
        wT = xT[pad + oy:pad + oy + NY, pad + ox:pad + ox + NX]
        wp = xp[pad + oy:pad + oy + NY, pad + ox:pad + ox + NX]
        yT = yT + S[0, k] * wT + S[1, k] * wp
        yp = yp + S[2, k] * wT + S[3, k] * wp
    return torch.cat([yT.reshape(-1), yp.reshape(-1)])


class BlockNewtonKrylov:
    """Iterative solver for BC-eliminated block systems J dx = b.

    The global system is the 2n x 2n two-field Jacobian with essential
    rows/columns replaced by identity (the elimination the host LU path
    applies with d @ J @ d + I_ess).

    Parameters
    ----------
    element_dofs : (ne, nd) int array — scalar-space element DOF map.
    n            : scalar-space true-dof count (system size is 2n).
    ess_T, ess_p : essential-DOF index arrays for the T and p fields.
    restart, maxiter : GMRES(m) restart length and outer-cycle cap.
    dof_lattice  : (NY, NX) strip lattice for the stencil (DIA) matvec.
    pc           : "pointblock" (the 2x2 point-block factors) or "linemg"
                   (``solvers.linemg.StripLineMG``; needs an order-1 lattice).
    device       : where the factors and the solve live.
    """

    def __init__(self, element_dofs, n, ess_T, ess_p,
                 restart: int = 400, maxiter: int = 10, dof_lattice=None,
                 pc: str = "pointblock", *, device):
        if pc not in ("pointblock", "linemg"):
            raise ValueError(f"unknown pc {pc!r}")
        self.pc = pc
        self.device = torch.device(device)
        ed = np.asarray(element_dofs, dtype=np.int64)
        self.ne, self.nd = ed.shape
        self.n = int(n)
        index = lambda a: torch.as_tensor(a, device=self.device)
        self.eldofs = index(ed)
        mask = np.zeros(2 * self.n, dtype=bool)
        mask[np.asarray(ess_T, dtype=np.int64)] = True
        mask[np.asarray(ess_p, dtype=np.int64) + self.n] = True
        self.mask2 = index(mask)
        # local essential masks over the stacked [T_e; p_e] element vector
        lT = mask[:self.n][ed]                      # (ne, nd)
        lp = mask[self.n:][ed]
        self.lmask = index(np.concatenate([lT, lp], axis=1))
        self.restart = int(restart)
        self.maxiter = int(maxiter)
        self._init_lattice(ed, mask, dof_lattice)
        self.mg = None
        if pc == "linemg":
            if self.lattice is None:
                raise ValueError("pc='linemg' requires a dof lattice")
            self.mg = StripLineMG(self.lattice["NY"], self.lattice["NX"],
                                  self.lattice["offs"])

    def _init_lattice(self, ed, mask, dof_lattice):
        """Precompute the stencil-assembly map for lattice (DIA) mode.

        On a tensor-product dof lattice the assembled Jacobian is a small
        stencil of 2x2 field blocks per dof (9-point at order 1, 25-point
        at order 2, ...), so the GMRES matvec becomes shifted-window
        multiplies over the (NY, NX) grid.  The assembly runs once per
        Jacobian rebuild inside ``prepare``."""
        self.lattice = None
        self.wlat = None
        if dof_lattice is None:
            return
        lat = np.asarray(dof_lattice, dtype=np.int64)
        NY, NX = lat.shape
        if NY * NX != self.n:
            raise ValueError("dof_lattice must enumerate every scalar dof")
        latflat = lat.reshape(-1)                   # lattice pos -> dof
        perm = np.empty(self.n, np.int64)
        perm[latflat] = np.arange(self.n)           # dof -> lattice pos
        ly, lx = perm // NX, perm % NX
        # offset of entry (e, a, b): coord(col dof) - coord(row dof)
        oy = ly[ed][:, None, :] - ly[ed][:, :, None]   # (ne, nd, nd)
        ox = lx[ed][:, None, :] - lx[ed][:, :, None]
        # bijective key for |ox| <= NX; decode with the +NX bias so
        # negative x-offsets round to the correct row
        off_keys = oy * (2 * NX + 1) + ox
        uniq, off_idx = np.unique(off_keys.ravel(), return_inverse=True)
        qy = (uniq + NX) // (2 * NX + 1)
        offs = np.stack([qy, uniq - qy * (2 * NX + 1)], axis=1)
        KO = len(uniq)
        pad = int(max(np.abs(offs).max(), 1))
        row_pos = (ly[ed][:, :, None] * NX
                   + lx[ed][:, :, None]) * np.ones((1, 1, self.nd),
                                                   dtype=np.int64)
        stencil_idx = off_idx.reshape(ed.shape[0], self.nd, self.nd) \
            * (NY * NX) + row_pos
        # windowed assembly when every element shares one lattice dof
        # stencil and elements are row-major over the cell lattice
        # (make_cartesian_mesh_2d; GMSH strips after the lattice_residual
        # renumbering): nd^2 shifted overlap-adds per rebuild
        kab = None
        offab = off_idx.reshape(ed.shape[0], self.nd, self.nd)
        if (offab == offab[0]).all():
            try:
                self.wlat = StripLatticeOps(ed, self.n, lat,
                                            device=self.device)
                kab = offab[0].tolist()    # offset slot of entry (a, b)
            except ValueError:
                pass
        index = lambda a: torch.as_tensor(a, device=self.device)
        self.lattice = {
            "kab": kab,
            "NY": NY, "NX": NX, "KO": KO, "pad": pad,
            "offs": [(int(a), int(b)) for a, b in offs],
            "idx": index(stencil_idx.reshape(-1)),
            "latflat2": index(np.concatenate([latflat, latflat + self.n])),
            "dofperm2": index(np.concatenate([perm, perm + self.n])),
            "latflat": index(latflat),
            "mask2_lat": index(np.concatenate([mask[:self.n][latflat],
                                               mask[self.n:][latflat]])),
        }

    # -- Jacobian preparation (once per Newton rebuild) ---------------------

    def _prepare_core(self, Je):
        """BC elimination, equilibration and the PC (see
        ``equilibrated_block_factors``); in lattice mode also assembles the
        scaled blocks into the (4, KO, NY, NX) stencil and permutes the
        PC/scaling vectors into lattice layout.  With ``pc="linemg"`` the
        line-MG level hierarchy takes the point-block factors' place."""
        Je_s, pb, s = equilibrated_block_factors(
            Je, self.lmask, self.mask2, self._gather, self._scatter,
            self.nd, self.n)
        if self.lattice is None:
            return Je_s, pb, s
        L = self.lattice
        nd = self.nd
        NY, NX = L["NY"], L["NX"]
        blocks = torch.stack([Je_s[:, :nd, :nd], Je_s[:, :nd, nd:],
                              Je_s[:, nd:, :nd], Je_s[:, nd:, nd:]])
        if self.wlat is not None:
            # nd^2 shifted overlap-adds (row dof a of every cell lands at
            # its lattice window; the offset slot k is fixed per (a, b))
            wl, kab = self.wlat, L["kab"]
            S = torch.zeros((4, L["KO"], NY, NX), dtype=Je_s.dtype,
                            device=Je_s.device)
            bc = blocks.reshape(4, wl.nyc, wl.nxc, nd, nd)
            for a in range(nd):
                for b in range(nd):
                    wl.add_window(S[:, kab[a][b]], bc[:, :, :, a, b], a)
        else:
            ngrid = L["KO"] * NY * NX
            idx4 = (L["idx"][None] + (torch.arange(4, device=Je_s.device)
                                      * ngrid)[:, None])
            S = torch.zeros(4 * ngrid, dtype=Je_s.dtype, device=Je_s.device)
            S.index_add_(0, idx4.reshape(-1), blocks.reshape(-1))
            S = S.reshape(4, L["KO"], NY, NX)
        if self.mg is not None:
            return S, self.mg.setup(S, L["mask2_lat"], self.n), \
                s[L["latflat2"]]
        return S, pb[:, L["latflat"]], s[L["latflat2"]]

    @staticmethod
    def _assemble_element_blocks(JTT, JTp, JpT, Jpp):
        top = torch.cat([JTT, JTp], dim=2)
        bot = torch.cat([JpT, Jpp], dim=2)
        return torch.cat([top, bot], dim=1)      # (ne, 2nd, 2nd)

    def prepare(self, blocks, face=None, face_elem=None):
        """Build device factors from element (and optional boundary-face)
        blocks.

        blocks    : (JTT, JTp, JpT, Jpp), each (ne, nd, nd).
        face      : optional (FJT, FJp), each (nbf, nd, nd) — boundary-face
                    contributions to the T rows.
        face_elem : (nbf,) adjacent-element ids for the face blocks.
        """
        Je = self._assemble_element_blocks(*blocks)
        if face is not None:
            Fe = torch.cat(list(face), dim=2)       # (nbf, nd, 2nd)
            fe = torch.as_tensor(np.asarray(face_elem, dtype=np.int64),
                                 device=Je.device)
            Je = Je.clone()
            Je[:, :self.nd, :].index_add_(0, fe, Fe)
        return self._prepare_core(Je)

    # -- apply / preconditioner / solve -------------------------------------

    def _gather(self, x):
        if self.wlat is not None:
            return torch.cat(
                [self.wlat.gather_elem(self.wlat.to_lat(x[:self.n])),
                 self.wlat.gather_elem(self.wlat.to_lat(x[self.n:]))], dim=1)
        return torch.cat([x[:self.n][self.eldofs], x[self.n:][self.eldofs]],
                         dim=1)                   # (ne, 2nd)

    def _scatter(self, y_e):
        if self.wlat is not None:
            return torch.cat([self.wlat.scatter(y_e[:, :self.nd]),
                              self.wlat.scatter(y_e[:, self.nd:])])
        flat = self.eldofs.reshape(-1)
        out = torch.zeros(2 * self.n, dtype=y_e.dtype, device=y_e.device)
        out[:self.n].index_add_(0, flat, y_e[:, :self.nd].reshape(-1))
        out[self.n:].index_add_(0, flat, y_e[:, self.nd:].reshape(-1))
        return out

    def _solve_impl(self, Je_s, pb, s, b, rtol, atol):
        if self.lattice is not None:
            L = self.lattice
            bl = b[L["latflat2"]]
            if self.mg is not None:
                # pb is the line-MG level hierarchy
                def apply_A(y):
                    return torch.where(L["mask2_lat"], y,
                                       _shift_windows(Je_s, y, L, self.n))

                res = gmres(apply_A, s * bl,
                            M=lambda r: self.mg.apply(pb, r,
                                                      mask=L["mask2_lat"]),
                            rtol=rtol, atol=atol, restart=self.restart,
                            maxiter=self.maxiter)
                res = res._replace(x=s * res.x)
            else:
                res = solve_equilibrated(
                    lambda y: _shift_windows(Je_s, y, L, self.n), pb, s, bl,
                    L["mask2_lat"], self.n, rtol, atol, self.restart,
                    self.maxiter)
            return res._replace(x=res.x[L["dofperm2"]])

        def matvec(y):
            return self._scatter(torch.einsum("eij,ej->ei", Je_s,
                                              self._gather(y)))

        return solve_equilibrated(matvec, pb, s, b, self.mask2, self.n,
                                  rtol, atol, self.restart, self.maxiter)

    def solve(self, factors, b, rtol=1e-10, atol=0.0):
        """Solve J dx = b to the given preconditioned-residual tolerance
        (measured on the equilibrated system).

        Returns the krylov ``SolveResult`` (x, iters=restart cycles,
        final residual, converged flag)."""
        return self._solve_impl(*factors, b, float(rtol), float(atol))


class BlockTridiagDirect(BlockNewtonKrylov):
    """Block-QR direct solver for strip dof lattices (the reference's MUMPS
    LU analog).

    On an (NY, NX) dof lattice whose assembled stencil couples adjacent
    y-levels only (order-1 strips: 9-point stencil), the equilibrated
    two-field Jacobian is block-tridiagonal with dense (2 NX, 2 NX) level
    blocks.  The factorization and the two sweeps are loops over the NY
    levels of small dense products: no Krylov iteration beyond the GMRES
    that this banded solve preconditions, and Newton gets true Newton
    directions, as with the reference's direct solves.

    Same ``prepare``/``solve`` surface as ``BlockNewtonKrylov``."""

    def __init__(self, element_dofs, n, ess_T, ess_p, dof_lattice,
                 restart: int = 16, maxiter: int = 6, *, device):
        super().__init__(element_dofs, n, ess_T, ess_p, restart=restart,
                         maxiter=maxiter, dof_lattice=dof_lattice,
                         device=device)
        if self.lattice is None:
            raise ValueError("BlockTridiagDirect requires a dof lattice")
        if max(abs(oy) for oy, _ in self.lattice["offs"]) > 1:
            raise ValueError(
                "stencil couples beyond adjacent y-levels (order > 1); "
                "use the GMRES path")

    # -- preparation: stencil -> level blocks -> block-QR factors --------

    def _level_blocks(self, S):
        """Scatter the (4, KO, NY, NX) DIA stencil into dense per-level
        blocks A (diag), B (couples y-1), C (couples y+1), each
        (NY, 2NX, 2NX), with essential rows replaced by identity."""
        L = self.lattice
        NY, NX = L["NY"], L["NX"]
        m = 2 * NX
        z = lambda: torch.zeros((NY, m, m), dtype=S.dtype, device=S.device)
        blk = {0: z(), -1: z(), 1: z()}
        for k, (oy, ox) in enumerate(L["offs"]):
            lo, hi = max(0, -ox), NX - max(0, ox)
            if hi <= lo:
                continue
            rows = torch.arange(lo, hi, device=S.device)
            cols = rows + ox
            for fg, (f, g) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                blk[oy][:, f * NX + rows, g * NX + cols] += S[fg, k][:, lo:hi]
        A, B, C = blk[0], blk[-1], blk[1]
        n = self.n
        mT = L["mask2_lat"][:n].reshape(NY, NX)
        mp = L["mask2_lat"][n:].reshape(NY, NX)
        mrow = torch.cat([mT, mp], dim=1).to(S.dtype)   # (NY, m)
        keep = (1.0 - mrow)[:, :, None]
        eye = torch.eye(m, dtype=S.dtype, device=S.device)
        return A * keep + eye[None] * mrow[:, :, None], B * keep, C * keep

    def _prepare_core(self, Je):
        """Block-QR elimination down the levels (orthogonal transforms
        bound the growth factor, where block Thomas grows ~1e6 on the graded
        case-1 strip).  Fill-in makes the upper factor block-pentadiagonal:
        row y carries (R_y upper triangular, C1_y, E_y) coupling x_{y+1}
        and x_{y+2}; the level Q factors are kept to transform the rhs at
        solve time."""
        S, _, s = super()._prepare_core(Je)
        A, B, C = self._level_blocks(S)
        NY, m = A.shape[0], A.shape[1]
        zm = torch.zeros((m, m), dtype=A.dtype, device=A.device)
        Rs, C1s, Es, Qs = [], [], [], []
        Dc, Cc = A[0], C[0]                 # current top row (E = 0)
        for y in range(1, NY):
            M = torch.cat([Dc, B[y]], dim=0)                    # (2m, m)
            Q, R = torch.linalg.qr(M, mode="complete")          # Q (2m, 2m)
            right = Q.T @ torch.cat([torch.cat([Cc, zm], dim=1),
                                     torch.cat([A[y], C[y]], dim=1)], dim=0)
            Rs.append(R[:m])
            C1s.append(right[:m, :m])
            Es.append(right[:m, m:])
            Qs.append(Q)
            Dc, Cc = right[m:, :m], right[m:, m:]
        # final level: QR of the remaining (m, m) block
        Qf, Rf = torch.linalg.qr(Dc, mode="complete")
        fac = (torch.stack(Rs), torch.stack(C1s), torch.stack(Es),
               torch.stack(Qs), Qf, Rf)
        return S, fac, s

    # -- solve: rhs transform + block back-substitution --------------------

    @staticmethod
    def _banded_solve(fac, blev):
        R, C1, E, Q, Qf, Rf = fac
        m = blev.shape[1]
        zc, Z = blev[0], []
        for y in range(Q.shape[0]):
            zz = Q[y].T @ torch.cat([zc, blev[y + 1]])
            Z.append(zz[:m])
            zc = zz[m:]
        zl = Qf.T @ zc
        tri = lambda Rm, v: torch.linalg.solve_triangular(
            Rm, v[:, None], upper=True)[:, 0]
        xl = tri(Rf, zl)
        x1, x2 = xl, torch.zeros_like(xl)   # x_{y+1}, x_{y+2}
        X = [xl]
        for y in range(Q.shape[0] - 1, -1, -1):
            x = tri(R[y], Z[y] - C1[y] @ x1 - E[y] @ x2)
            X.append(x)
            x1, x2 = x, x1
        return torch.stack(X[::-1])

    def _dia_matvec(self, S, y):
        """Equilibrated stencil matvec in lattice order (mask rows pass
        through as identity, matching the assembled identity rows)."""
        L = self.lattice
        return torch.where(L["mask2_lat"], y,
                           _shift_windows(S, y, L, self.n))

    def _to_levels(self, v):
        NY, NX = self.lattice["NY"], self.lattice["NX"]
        return torch.cat([v[:self.n].reshape(NY, NX),
                          v[self.n:].reshape(NY, NX)], dim=1)

    def _from_levels(self, X):
        NX = self.lattice["NX"]
        return torch.cat([X[:, :NX].reshape(-1), X[:, NX:].reshape(-1)])

    def _solve_impl(self, S, fac, s, b, rtol, atol):
        """GMRES with the banded-QR solve as (near-exact) left
        preconditioner.  A pure direct solve is not enough here: the
        equilibrated ablation Jacobian measures cond ~1e15, so even the
        backward-stable QR leaves a residual that float32 cannot bear
        (0.17 relative at the real step-1 state); GMRES minimizes the
        preconditioned residual over the Krylov space, and with M ~= A^-1
        it gets there in one or two iterations (float64)."""
        L = self.lattice
        bl = b[L["latflat2"]]

        def M(r):
            return self._from_levels(self._banded_solve(fac,
                                                        self._to_levels(r)))

        res = gmres(lambda y: self._dia_matvec(S, y), s * bl, M=M,
                    rtol=rtol, atol=atol, restart=self.restart,
                    maxiter=self.maxiter)
        return res._replace(x=(s * res.x)[L["dofperm2"]])


def make_scan_block_solver(cfg, element_dofs, n, ess_T, ess_p,
                           node_positions, *, device):
    """Device linear solver for the scan-path Newton loops: the block-QR
    direct solver when the mesh qualifies (order-1 strip dof lattice;
    ``lattice_direct: false`` opts out), else equilibrated block GMRES
    (``gmres_lattice: true`` uses the DIA matvec when a lattice exists)."""
    lat = None
    if bool(cfg.get("gmres_lattice", True)):
        try:
            lat = strip_dof_lattice(node_positions)
        except ValueError:
            lat = None
    if lat is not None and bool(cfg.get("lattice_direct", True)):
        try:
            return BlockTridiagDirect(element_dofs, n, ess_T, ess_p,
                                      dof_lattice=lat, device=device)
        except ValueError:
            pass
    return BlockNewtonKrylov(
        element_dofs, n, ess_T, ess_p,
        restart=int(cfg.get("gmres_restart", 400)),
        maxiter=int(cfg.get("gmres_maxiter", 10)),
        dof_lattice=lat, device=device)
