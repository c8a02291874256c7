"""Plain reference of a step of the charring-ablator case 2.2 (TACOT strip,
surface thermochemistry, receding top).

The equations are those of the reference deck (ablation_test_case2_2_2D.cpp,
as ``cmfem_tpu_torch/physics/ablation.py``, ``seb.py``, ``bprime.py`` and
``motion/`` state them for case 2.2 with its defaults: recession on, the
ALE advective terms on, no GCL storage, the recession density the char
surface's), written here again in plain PyTorch, numpy and scipy on
bilinear quads with 3 x 3 Gauss points and 3 Gauss points on each top edge.
The material, its tables, the extents and the element residual of the
volume are case 1's (``ablation_case1.py``), with the mesh velocity's
advective terms added to the flux weights: (rho_s cp T + eps_g (rho h - p))
w in the energy equation and eps_g rho w in the mass equation.

A step follows the published order (SURVEY section 3.5, :4060-4247):

1. the lumped top recession velocity m_dot_c / rho_rec at the top vertices
   (:2740-2953), on the element means of the committed extents, with
   m_dot_c = rho_e u_e C_H B'c phi from the coupled B'g + B'c fixed point
   (8 sweeps, :724-795);
2. the mesh velocity: the Laplacian with -v on the top vertices and 0 on
   the bottom ones, the vertical component only;
3. the semi-Lagrangian extent remap (:3148-3273): each quadrature point
   takes the extents of the nearest quadrature point of the element that
   holds x_q + w_q dt on the mesh before the move;
4. the move, x + w dt, and the total recession, mean(v) dt over the top;
5. Newton on the moved mesh: the volume residual with the ALE terms
   (:1468-1469, :1504-1516) and the surface energy balance on the top
   edges (:1884-1927), -int q_surf psi ds, with q_surf = q_conv + q_adv_pyro
   + q_rad_emit + q_rad_abs; element and face Jacobians by forward AD
   (``torch.func``), a sparse LU (``scipy``) of the equilibrated matrix;
   p Dirichlet at the top (the schedule's p_w), T free;
6. the extent advance at the converged temperatures.

The B' table is a list of rows (p, B'g, B'c, T, h_w): each (p, B'g) level
a natural cubic spline in T, then linear in B'g and in log p, each axis
clamped to the table.  The surface schedule is a list of rows (t, p_w,
rho_e u_e C_H, h_r, h_conv, T_edge, chemistry): linear in t, the chemistry
switch constant from the left.

Where this departs from the program, and why:

- the mesh velocity by a sparse direct solve, where the program runs a
  Jacobi CG to rtol 1e-12 with at most 500 iterations (about 340 on the
  deck's 11 x 239 strip): the reference is the exact discrete velocity;
- the remap's donor element found by brute force over every element
  (bounding box, then the bilinear inverse map), the QP's own element taken
  first where it holds the point and else the lowest-numbered one, where
  the program tries the own element and locates the rest;
- no mesh-quality guard: a step that folds an element raises;
- Newton stops on the size of its update (1e-10 of the fields, 100 eps in
  a lower precision), where the program stops on its residual.

Nothing here comes from the program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from bench_port.harness import load_module

case1 = load_module("reference", "ablation_case1")
strip_mesh, refine, write_gmsh = case1.strip_mesh, case1.refine, \
    case1.write_gmsh
MU_FLOOR = case1.MU_FLOOR
BLOWING_SWEEPS = 8


# -- the tables the configuration states --------------------------------------

def bprime_rows(spec):
    """(N, 5) rows (p, B'g, B'c, T, h_w) of the configuration's B' table:
    every (p, B'g, T) of its grids, T fastest, with
    B'c = plateau / (1 + B'g) / (1 + exp(-(T - T_ox) / w_ox))
          + a / (1 + exp(-(T - T_s) / w_s)),
    T_ox = T_ox0 + k_ox log10(p / p_ox + floor), T_s = T_s0 + k_s log10(p /
    p_s), and h_w = c1 (T - T0) + c2 (T - T0)^2 - d B'g / (1 + B'g)."""
    ox, su, hw = spec["oxidation"], spec["sublimation"], spec["wall_enthalpy"]
    ps = np.asarray(spec["p"], dtype=np.float64)
    bgs = np.asarray(spec["bg"], dtype=np.float64)
    lo, hi, num = spec["T"]
    Ts = np.linspace(float(lo), float(hi), int(num))
    P, BG, TT = np.meshgrid(ps, bgs, Ts, indexing="ij")
    T_ox = ox["T_ref"] + ox["T_per_decade"] * np.log10(P / ox["p_ref"]
                                                       + ox["log_floor"])
    T_s = su["T_ref"] + su["T_per_decade"] * np.log10(P / su["p_ref"])
    bc = (ox["plateau"] / (1.0 + BG)
          / (1.0 + np.exp(-(TT - T_ox) / ox["width"]))
          + su["amplitude"] / (1.0 + np.exp(-(TT - T_s) / su["width"])))
    dT = TT - hw["T_ref"]
    h = hw["linear"] * dT + hw["quadratic"] * dT ** 2 \
        - hw["dilution"] * BG / (1.0 + BG)
    return np.stack([P.ravel(), BG.ravel(), bc.ravel(), TT.ravel(),
                     h.ravel()], axis=1)


def schedule_rows(spec, plateau, h_r):
    """The surface schedule's rows (t, p_w, rho_e u_e C_H, h_r, h_conv,
    T_edge, chemistry) of a run whose rho_e u_e C_H plateau and h_r are
    given: a ramp from 0 over ``ramp_s``, held, chemistry off from
    ``chemistry_off_s``."""
    p_w, hc, te = (float(spec[k]) for k in ("p_w", "hconv", "T_edge"))
    ramp, on, off = (float(spec[k]) for k in ("ramp_s", "chemistry_on_s",
                                              "chemistry_off_s"))
    row = lambda t, r, chem: [t, p_w, r, h_r, hc, te, chem]
    return [row(0.0, 0.0, 1.0), row(ramp, plateau, 1.0),
            row(on, plateau, 1.0), row(off, plateau, 0.0),
            row(2.0 * on, plateau, 0.0)]


def boundary(rows, t):
    """The schedule at time t: a dict of p_w, rheuch, h_r, hconv, T_edge
    (linear between rows, the ends held) and chemistry (from the row at or
    before t: at a row's own time, the interval that ends there)."""
    r = np.asarray(rows, dtype=np.float64)
    if t <= r[0, 0]:
        mix = left = r[0]
    elif t >= r[-1, 0]:
        mix = left = r[-1]
    else:
        hi = int(np.searchsorted(r[:, 0], t, side="left"))
        hi = min(max(hi, 1), len(r) - 1)
        left, b = r[hi - 1], r[hi]
        span = b[0] - left[0]
        w = (t - left[0]) / span if span > 1e-14 else 0.0
        mix = (1 - w) * left + w * b
    return {"p_w": float(mix[1]), "rheuch": float(mix[2]),
            "h_r": float(mix[3]), "hconv": float(mix[4]),
            "T_edge": float(mix[5]), "chemistry": int(left[6] >= 0.5)}


class BPrime:
    """B'c and h_w at (p, B'g, T) from the table's rows, which hold every
    (p, B'g, T) of their grids."""

    def __init__(self, rows, device, dtype):
        rows = np.asarray(rows, dtype=np.float64)
        self.ps = np.unique(rows[:, 0])
        self.bgs = np.unique(rows[:, 1])
        Ts = np.unique(rows[:, 3])
        order = np.lexsort((rows[:, 3], rows[:, 1], rows[:, 0]))
        grid = rows[order].reshape(len(self.ps), len(self.bgs), len(Ts), 5)
        if not (grid[..., 3] == Ts).all():
            raise ValueError("the B' rows do not fill their grid")
        y = np.moveaxis(grid[..., [2, 4]], -1, 2)     # (Lp, Lbg, 2, nT)
        y2 = case1.natural_y2(Ts, y.reshape(-1, len(Ts))).reshape(y.shape)
        tt = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=device)
        self.T, self.y, self.y2 = tt(Ts), tt(y), tt(y2)
        self.bgs_t = tt(self.bgs)

    def _splines(self, i, T):
        """(Lbg, 2, *T.shape): the natural cubic splines of pressure level
        i at T, clamped to the knots."""
        x, y, y2 = self.T, self.y[i], self.y2[i]
        Tq = torch.minimum(torch.maximum(T, x[0]), x[-1])
        k = torch.clamp(torch.searchsorted(x, Tq.detach().contiguous()), 1,
                        len(x) - 1) - 1
        h = x[k + 1] - x[k]
        a, b = (x[k + 1] - Tq) / h, (Tq - x[k]) / h
        return (a * y[..., k] + b * y[..., k + 1]
                + ((a ** 3 - a) * y2[..., k] + (b ** 3 - b) * y2[..., k + 1])
                * h * h / 6.0)

    def __call__(self, p_w, bg, T):
        """(B'c, h_w) at the pressure p_w (a number) and B'g, T (tensors of
        one shape)."""
        L = len(self.bgs)
        bq = torch.minimum(torch.maximum(bg, self.bgs_t[0]), self.bgs_t[-1])
        hi = torch.clamp(torch.searchsorted(self.bgs_t,
                                            bq.detach().contiguous()),
                         1, L - 1)
        lo = hi - 1
        w = (bq - self.bgs_t[lo]) / (self.bgs_t[hi] - self.bgs_t[lo])
        ids = torch.arange(L, device=T.device).reshape((L,) + (1,) * T.dim())
        weight = ((ids == lo[None]) * (1.0 - w[None])
                  + (ids == hi[None]) * w[None])          # (L, *S)
        at_p = lambda i: torch.sum(weight[:, None] * self._splines(i, T),
                                   dim=0)
        if len(self.ps) == 1:
            out = at_p(0)
        else:
            pq = min(max(float(p_w), self.ps[0]), self.ps[-1])
            j = min(max(int(np.searchsorted(self.ps, pq)), 1),
                    len(self.ps) - 1)
            lp0, lp1 = np.log(self.ps[j - 1]), np.log(self.ps[j])
            a = (np.log(pq) - lp0) / (lp1 - lp0)
            out = sum(c * at_p(i) for i, c in ((j - 1, 1.0 - a), (j, a))
                      if c != 0.0)
        return out[0], out[1]


def blowing_correction(B, lam):
    """phi = ln(1 + 2 lam B) / (2 lam B), its series below 1e-10."""
    arg = 2.0 * lam * torch.clamp(B, min=0.0)
    small = arg < 1e-10
    safe = torch.where(small, 1.0, arg)
    return torch.where(small, 1.0 - 0.5 * arg + arg * arg / 3.0,
                       torch.log1p(safe) / safe)


# -- geometry -----------------------------------------------------------------

def _segment_rule():
    g, w = np.polynomial.legendre.leggauss(3)
    return 0.5 * (g + 1.0), 0.5 * w


def _q1(xi, eta):
    """Bilinear basis values (..., 4) and reference gradients (..., 4, 2)."""
    N = np.stack([(1 - xi) * (1 - eta), xi * (1 - eta), xi * eta,
                  (1 - xi) * eta], axis=-1)
    dN = np.stack([np.stack([-(1 - eta), -(1 - xi)], -1),
                   np.stack([(1 - eta), -xi], -1),
                   np.stack([eta, xi], -1),
                   np.stack([-eta, (1 - xi)], -1)], axis=-2)
    return N, dN


def _inverse_grads(dN, xe):
    """Physical gradients (..., 4, 2) and det J (...) of bilinear maps:
    dN (..., 4, 2) reference gradients, xe (..., 4, 2) element vertices."""
    J = torch.einsum("...ar,...ad->...dr", dN, xe)
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    inv = torch.stack([torch.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                       torch.stack([-J[..., 1, 0], J[..., 0, 0]], -1)],
                      -2) / det[..., None, None]
    return torch.einsum("...ar,...rd->...ad", dN, inv), det


class Case22Reference:
    """The strip (vertices (nv, 2), quads (ne, 4) counter-clockwise, top
    segments (nt, 2), bottom vertex ids), the deck, the B' rows and the
    surface model ({lambda, emissivity, reflectivity, T_background, q_rad,
    stefan_boltzmann}); ``step`` advances (T, p, extents, vertices, total
    recession) by one time step."""

    def __init__(self, deck, verts, quads, top_segs, bottom, bprime_rows_,
                 surface, device, dtype=torch.float64):
        self.device, self.dtype = device, dtype
        self.mat = case1.Material(deck, device, dtype)
        self.bprime = BPrime(bprime_rows_, device, dtype)
        self.surface = {k: float(v) for k, v in surface.items()}
        self.verts0 = np.asarray(verts, dtype=np.float64)
        q = np.asarray(quads, dtype=np.int64)
        self.quads_np = q
        self.quads = torch.as_tensor(q, device=device)
        self.nv, self.ne = len(verts), len(q)
        self.N, self.dN, self.W = case1._q1_tables(device, dtype)
        self.qp_ref = np.stack(np.meshgrid(*[_segment_rule()[0]] * 2,
                                           indexing="xy"), -1).reshape(-1, 2)
        self.top = np.unique(np.asarray(top_segs))
        self.bottom = np.unique(np.asarray(bottom))
        self._faces(np.asarray(top_segs))
        self._rows = np.repeat(q, 4, axis=1).reshape(-1)
        self._cols = np.tile(q, (1, 4)).reshape(-1)
        fq = q[self.face_elem]
        self._frows = np.repeat(fq, 4, axis=1).reshape(-1)
        self._fcols = np.tile(fq, (1, 4)).reshape(-1)
        mask = np.zeros(2 * self.nv, dtype=bool)
        mask[self.top + self.nv] = True     # p at the top; T is free
        self.mask = mask
        self.mask_t = torch.as_tensor(mask, device=device)

    def _faces(self, segs):
        """Each top segment's element, its 3 points in the element's
        reference square and their weights on [0, 1]."""
        ref = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
        elem, pts = [], []
        s, w = _segment_rule()
        for a, b in segs:
            e = int(np.nonzero((self.quads_np == a).any(1)
                               & (self.quads_np == b).any(1))[0][0])
            la = int(np.nonzero(self.quads_np[e] == a)[0][0])
            lb = int(np.nonzero(self.quads_np[e] == b)[0][0])
            elem.append(e)
            pts.append(ref[la][None] * (1 - s)[:, None]
                       + ref[lb][None] * s[:, None])
        pts = np.array(pts)                                  # (nf, 3, 2)
        N, dN = _q1(pts[..., 0], pts[..., 1])
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        self.face_elem = np.array(elem)
        self.face_elem_t = torch.as_tensor(self.face_elem, device=self.device)
        self.fN, self.fdN, self.fw = t(N), t(dN), t(w)
        self.segs = torch.as_tensor(np.asarray(segs), device=self.device)

    # -- geometry of a vertex tensor ---------------------------------------

    def tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def geometry(self, V):
        """Element gradients (ne, 9, 4, 2) and weights x det J (ne, 9);
        face gradients (nf, 3, 4, 2), normals (nf, 2) and weights x length
        (nf, 3)."""
        xe = V[self.quads]
        grad, det = _inverse_grads(self.dN[None], xe[:, None])
        if not bool((det > 0).all()):
            raise RuntimeError("reference: a step folded an element")
        fxe = xe[self.face_elem_t]
        fgrad, _ = _inverse_grads(self.fdN, fxe[:, None])
        a, b = V[self.segs[:, 0]], V[self.segs[:, 1]]
        d = b - a
        length = torch.sqrt(torch.sum(d * d, dim=-1))
        nrm = torch.stack([d[:, 1], -d[:, 0]], -1) / length[:, None]
        out = fxe.mean(dim=1) - 0.5 * (a + b)      # centroid side: inward
        nrm = torch.where((torch.sum(nrm * out, -1) > 0)[:, None], -nrm, nrm)
        return {"grad": grad, "wdet": self.W * det,
                "fgrad": fgrad, "normal": nrm,
                "wds": self.fw[None] * length[:, None]}

    def at_qp(self, u):
        return torch.einsum("qa,ea->eq", self.N, u.to(self.dtype)[self.quads])

    def advance(self, X_old, T, dt):
        return self.mat.extents(self.at_qp(T), dt, X_old)

    # -- the surface energy balance ----------------------------------------

    def surface_terms(self, Tw, pw, gpw, Xrep, normal, bc):
        """q_surf, m_dot_c and rho_s at face points (Tw (..., 3), gpw (...,
        3, 2), Xrep (..., nr), normal (..., 2))."""
        mat, sf = self.mat, self.surface
        Xf = torch.broadcast_to(Xrep[..., None, :], Tw.shape + Xrep.shape[-1:])
        s = mat.solid(Tw, pw, Xf)
        g = mat.gas_props(Tw, pw)
        rd = g["rho"] * s["K"] / torch.clamp(g["mu"], min=MU_FLOOR)
        mdot_g = torch.sum(-rd[..., None] * gpw * normal[..., None, :], -1)
        emis = sf["emissivity"]
        absorb = min(max(1.0 - sf["reflectivity"], 0.0), 1.0)
        q_rad = -emis * sf["stefan_boltzmann"] * (
            Tw ** 4 - sf["T_background"] ** 4) + absorb * sf["q_rad"]
        zero = torch.zeros_like(Tw)
        if not bc["chemistry"]:
            q = bc["hconv"] * (bc["T_edge"] - Tw) + q_rad
            return q, zero, s["rho_s"]
        rheuch = max(0.0, bc["rheuch"])
        Bg, phi = zero, torch.ones_like(Tw)
        if rheuch > 1e-14:
            # the coupled fixed point: phi of the total B'g + B'c
            for _ in range(BLOWING_SWEEPS):
                Bg = torch.clamp(mdot_g / (rheuch * torch.clamp(phi,
                                                                min=1e-12)),
                                 min=0.0)
                Bc, hw = self.bprime(bc["p_w"], Bg, Tw)
                phi = blowing_correction(Bg + Bc, sf["lambda"])
        else:
            Bc, hw = self.bprime(bc["p_w"], Bg, Tw)
        q = rheuch * phi * (bc["h_r"] - hw) - mdot_g * hw + q_rad
        return q, rheuch * Bc * phi, s["rho_s"]

    def _face_res(self, bc):
        def res(Te, pe, N, grad, nrm, wds, Xr):
            Tw, pw = N @ Te, N @ pe
            # the wall gradient from the values less the first: exactly 0
            # at a uniform p
            gpw = torch.einsum("qad,a->qd", grad, pe - pe[0])
            q, _, _ = self.surface_terms(Tw, pw, gpw, Xr, nrm, bc)
            return -(N.T @ (q * wds))
        return res

    def recession_velocity(self, T, p, X, V, bc, geo=None):
        """The lumped recession velocity (nv,): sum over the top edges of
        max(0, m_dot_c) / max(rho_s, 1e-8) psi ds over the sum of psi ds,
        at the top vertices, on the element means of the extents."""
        geo = geo or self.geometry(V)
        fe = self.face_elem_t
        Te, pe = T[self.quads][fe], p[self.quads][fe]
        Tw = torch.einsum("fqa,fa->fq", self.fN, Te)
        pw = torch.einsum("fqa,fa->fq", self.fN, pe)
        gpw = torch.einsum("fqad,fa->fqd", geo["fgrad"], pe - pe[:, :1])
        _, mdot_c, rho_s = self.surface_terms(Tw, pw, gpw, X.mean(dim=1)[fe],
                                              geo["normal"], bc)
        vq = torch.clamp(mdot_c, min=0.0) / torch.clamp(rho_s, min=1e-8)
        ids = self.quads[fe].reshape(-1)
        num = torch.zeros(self.nv, dtype=self.dtype, device=self.device)
        den = torch.zeros_like(num)
        num.index_add_(0, ids, torch.einsum("fqa,fq->fa", self.fN,
                                            vq * geo["wds"]).reshape(-1))
        den.index_add_(0, ids, torch.einsum("fqa,fq->fa", self.fN,
                                            geo["wds"]).reshape(-1))
        v = torch.where(den > 1e-16, num / torch.where(den > 1e-16, den, 1.0),
                        0.0)
        v = torch.where(torch.isfinite(v) & (v > 0), v, 0.0)
        keep = torch.zeros_like(v, dtype=torch.bool)
        keep[torch.as_tensor(self.top, device=self.device)] = True
        return torch.where(keep, v, 0.0)

    # -- the mesh velocity and the remap -----------------------------------

    def stiffness(self, V):
        """The Laplacian's matrix (scipy CSR) on the vertices V."""
        geo_grad, det = _inverse_grads(self.dN[None], V[self.quads][:, None])
        Ke = torch.einsum("eqad,eqbd,eq->eab", geo_grad, geo_grad,
                          self.W * det)
        return sp.coo_matrix((Ke.reshape(-1).cpu().numpy(),
                              (self._rows, self._cols)),
                             shape=(self.nv, self.nv)).tocsr()

    def mesh_velocity(self, V, v):
        """The vertical mesh velocity (nv,): the Laplacian with -v at the
        top vertices and 0 at the bottom ones, by a direct solve."""
        K = self.stiffness(V)
        fixed = np.union1d(self.top, self.bottom)
        free = np.setdiff1d(np.arange(self.nv), fixed)
        u = np.zeros(self.nv, dtype=K.dtype)
        u[self.top] = -v.cpu().numpy()[self.top]
        u[free] = spla.spsolve(K[free][:, free].tocsc(),
                               -(K[free][:, fixed] @ u[fixed]))
        return torch.as_tensor(u, dtype=self.dtype, device=self.device)

    def locate(self, pts, V):
        """The element (or -1) and reference coordinates of each point:
        every element whose box holds it, by the bilinear inverse map; the
        point's own element first, else the lowest-numbered."""
        Vn = V.detach().cpu().numpy().astype(np.float64)
        xe = Vn[self.quads_np]                               # (ne, 4, 2)
        box = torch.as_tensor(np.stack([xe.min(axis=1) - 1e-12,
                                        xe.max(axis=1) + 1e-12]),
                              device=self.device)            # (2, ne, 2)
        m = len(pts)
        own = np.repeat(np.arange(self.ne), 9)
        pis, eis, refs = [], [], []
        for c0 in range(0, m, 2048):
            pc = pts[c0:c0 + 2048]
            pt = torch.as_tensor(pc, device=self.device)[:, None, :]
            inbox = ((pt >= box[0]) & (pt <= box[1])).all(-1)
            pi, ei = (a.cpu().numpy() for a in torch.nonzero(inbox,
                                                               as_tuple=True))
            r = np.full((len(pi), 2), 0.5)
            for _ in range(30):
                N, dN = _q1(r[:, 0], r[:, 1])
                x = np.einsum("ma,mad->md", N, xe[ei])
                J = np.einsum("mar,mad->mdr", dN, xe[ei])
                r = r + np.linalg.solve(J, (pc[pi] - x)[..., None])[..., 0]
            inside = ((r >= -1e-9) & (r <= 1 + 1e-9)).all(axis=1)
            pis.append(c0 + pi[inside])
            eis.append(ei[inside])
            refs.append(r[inside])
        pi, ei, r = (np.concatenate(a) for a in (pis, eis, refs))
        order = np.lexsort((ei, ei != own[pi], pi))
        first = order[np.unique(pi[order], return_index=True)[1]]
        elem = np.full(m, -1, dtype=np.int64)
        ref = np.zeros((m, 2))
        elem[pi[first]] = ei[first]
        ref[pi[first]] = r[first]
        return elem, ref

    def remap(self, X, V, w, dt):
        """Each QP's extents from the nearest QP of the element that holds
        x_q + w_q dt (the mesh before the move); a point found nowhere
        keeps its own."""
        xq = torch.einsum("qa,ead->eqd", self.N, V[self.quads])
        wq = torch.einsum("qa,ead->eqd", self.N, w[self.quads])
        pts = (xq + wq * dt).reshape(-1, 2).detach().cpu().numpy() \
            .astype(np.float64)
        elem, ref = self.locate(pts, V)
        d2 = ((ref[:, None, :] - self.qp_ref[None]) ** 2).sum(-1)
        src = elem * 9 + np.argmin(d2, axis=1)
        nr = X.shape[-1]
        flat = X.reshape(-1, nr)
        ok = torch.as_tensor(elem >= 0, device=self.device)
        src_t = torch.as_tensor(np.where(elem >= 0, src, 0),
                                device=self.device)
        out = torch.where(ok[:, None], torch.clamp(flat[src_t], 0.0, 1.0),
                          flat)
        return out.reshape(X.shape)

    # -- the Newton step on the moved mesh ---------------------------------

    def _elem_res(self, dt):
        mat, N = self.mat, self.N

        def res(Te, pe, grad, wdet, To, po, Xo, wq):
            Tq, pq = N @ Te, N @ pe
            gT = torch.einsum("qad,a->qd", grad, Te)
            gp = torch.einsum("qad,a->qd", grad, pe)
            X = mat.extents(Tq, dt, Xo)
            s = mat.solid(Tq, pq, X, Xo, dt)
            g = mat.gas_props(Tq, pq)
            so, go = mat.solid(To, po, Xo), mat.gas_props(To, po)
            rd = g["rho"] * s["K"] / torch.clamp(g["mu"], min=MU_FLOOR)
            e_m = s["eps_g"] * g["rho"]
            e_s = s["rho_s"] * s["cp"] * Tq
            e_g = s["eps_g"] * (g["rho"] * g["h"] - pq)
            r0p = (e_m - so["eps_g"] * go["rho"]) / dt - s["pi"]
            r1p = rd[:, None] * gp + e_m[:, None] * wq
            r0T = (s["rho_s"] * s["cp"] * (Tq - To) + e_g
                   - so["eps_g"] * (go["rho"] * go["h"] - po)) / dt \
                - s["sink"]
            r1T = s["k"][:, None] * gT + (g["h"] * rd)[:, None] * gp \
                + (e_s + e_g)[:, None] * wq
            pair = lambda r0, r1: (N.T @ (r0 * wdet)
                                   + torch.einsum("qad,qd->a", grad,
                                                  r1 * wdet[:, None]))
            return pair(r0T, r1T), pair(r0p, r1p)

        return res

    def _face_args(self, T, p, X, geo):
        fe = self.face_elem_t
        return (T[self.quads][fe], p[self.quads][fe], self.fN, geo["fgrad"],
                geo["normal"], geo["wds"], X[fe, 0])

    def residual(self, T, p, To_q, po_q, Xo, dt, wq, geo, bc):
        """The masked global residual (2 nv,) of a step."""
        rT, rp = torch.func.vmap(self._elem_res(dt))(
            T[self.quads], p[self.quads], geo["grad"], geo["wdet"], To_q,
            po_q, Xo, wq)
        fT = torch.func.vmap(self._face_res(bc))(
            *self._face_args(T, p, Xo, geo))
        R = torch.zeros(2 * self.nv, dtype=self.dtype, device=self.device)
        R.index_add_(0, self.quads.reshape(-1), rT.reshape(-1))
        R.index_add_(0, self.quads.reshape(-1) + self.nv, rp.reshape(-1))
        R.index_add_(0, self.quads[self.face_elem_t].reshape(-1),
                     fT.reshape(-1))
        return torch.where(self.mask_t, 0.0, R)

    def jacobian(self, T, p, To_q, po_q, Xo, dt, wq, geo, bc):
        jac = torch.func.vmap(torch.func.jacfwd(self._elem_res(dt),
                                                argnums=(0, 1)))
        (JTT, JTp), (JpT, Jpp) = jac(T[self.quads], p[self.quads],
                                     geo["grad"], geo["wdet"], To_q, po_q,
                                     Xo, wq)
        jf = torch.func.vmap(torch.func.jacfwd(self._face_res(bc),
                                               argnums=(0, 1)))
        FT, Fp = jf(*self._face_args(T, p, Xo, geo))
        n = self.nv
        r, c, fr, fc = self._rows, self._cols, self._frows, self._fcols
        rows = np.concatenate([r, r, r + n, r + n, fr, fr])
        cols = np.concatenate([c, c + n, c, c + n, fc, fc + n])
        vals = torch.cat([b.reshape(-1) for b in (JTT, JTp, JpT, Jpp, FT,
                                                    Fp)])
        J = sp.coo_matrix((vals.cpu().numpy(), (rows, cols)),
                          shape=(2 * n, 2 * n)).tocsr()
        keep = sp.diags((~self.mask).astype(J.dtype))
        return keep @ J @ keep + sp.diags(self.mask.astype(J.dtype))

    def newton(self, T_old, p_old, Xo, dt, wq, geo, bc, max_iter=60):
        """(T, p, iterations) of the step by Newton from the previous
        fields, p at the top the schedule's p_w, until the update is below
        1e-10 of the fields (100 eps of a lower precision, where that is
        more); the Jacobian and its LU kept while each update is below a
        quarter of the one before."""
        T = T_old.to(self.dtype).clone()
        p = p_old.to(self.dtype).clone()
        p[torch.as_tensor(self.top, device=self.device)] = bc["p_w"]
        To_q, po_q = self.at_qp(T_old), self.at_qp(p_old)
        n = self.nv
        tol = max(1e-10, 100 * torch.finfo(self.dtype).eps)
        lu, last = None, None
        for it in range(1, max_iter + 1):
            args = (To_q, po_q, Xo, dt, wq, geo, bc)
            R = self.residual(T, p, *args)
            if lu is None:
                J = self.jacobian(T, p, *args)
                dr = 1.0 / abs(J).max(axis=1).toarray().ravel()
                Js = sp.diags(dr) @ J
                dc = 1.0 / abs(Js).max(axis=0).toarray().ravel()
                lu = spla.splu((Js @ sp.diags(dc)).astype(J.dtype).tocsc())
            y = lu.solve(dr.astype(J.dtype) * -R.cpu().numpy())
            dx = torch.as_tensor(dc * y, dtype=self.dtype,
                                 device=self.device)
            if not bool(torch.isfinite(dx).all()):
                return T, p, it
            T, p = T + dx[:n], p + dx[n:]
            size = max(float(dx[:n].abs().max()) / float(T.abs().max()),
                       float(dx[n:].abs().max()) / float(p.abs().max()))
            if size <= tol:
                return T, p, it
            if last is not None and size > 0.25 * last:
                lu = None
            last = size
        return T, p, max_iter

    def step(self, T, p, X, V, total, dt, bc):
        """One step from (T, p) (nv,), extents X (ne, 9, nr), vertices V
        (nv, 2) and the total recession: (T, p, X, V, total)."""
        T, p, X, V = (self.tensor(a) for a in (T, p, X, V))
        v = self.recession_velocity(T, p, X, V, bc)
        mean_v = float(v[torch.as_tensor(self.top,
                                         device=self.device)].mean())
        w = torch.zeros_like(V)
        if mean_v > 0 and dt > 0:
            w[:, 1] = self.mesh_velocity(V, v)
        X = self.remap(X, V, w, dt)
        if mean_v > 0 and dt > 0:
            V = V + dt * w
            total = total + mean_v * dt
        geo = self.geometry(V)
        wq = torch.einsum("qa,ead->eqd", self.N, w[self.quads])
        T, p, _ = self.newton(T, p, X, dt, wq, geo, bc)
        return T, p, self.advance(X, T, dt), V, total
