"""Plain reference of a step of the charring-ablator case 1 (TACOT strip).

The equations are those of the reference deck (ablation_test_case1_2D.cpp,
as ``cmfem_tpu_torch/physics/ablation.py`` and ``tacot.py`` state them for
case 1: no gravity, no moving mesh), written here again in plain PyTorch
and numpy on bilinear quads with 3 x 3 Gauss points (the driver's
``quad_order`` 2 p + 2 at order 1):

- per quadrature point, the reaction extents of the step by backward Euler,
  x - x_old - dt A exp(-E / R T) (1 - x)^m T^n = 0 for T above a
  reaction's threshold, x kept in [x_old, 1] (Newton, 30 sweeps);
- solid properties blended between the virgin and char tables by the
  virgin-mass fraction, gas properties from the gas table, each a natural
  cubic spline in T per pressure level, linear in p, clamped at the ends;
- energy residual: (rho_s cp (T - T_old) + eps_g (rho h - p) - old) / dt
  - h_bar pi against the test function, k grad T + h rho K / mu grad p
  against its gradient; pressure residual: (eps_g rho - old) / dt - pi
  and rho K / mu grad p;
- Dirichlet rows: T at the top is the wall schedule, p at the top the top
  pressure.

``Case1Reference(deck, mesh)`` holds the mesh (vertices (nv, 2), quads (ne,
4) counter-clockwise, top vertex ids) and the material; ``advance``
computes the extents of a step at given temperatures, ``newton`` the
step's (T, p) from the previous state by Newton with element Jacobians
from forward-mode AD (``torch.func``) and a sparse LU (``scipy``) of the
row- and column-equilibrated matrix, kept for further iterations while
they contract fast.  The
vertex numbering is the degree-of-freedom numbering of an order-1 space.
Nothing here comes from the program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

MU_FLOOR = 1.0e-12
EXTENT_SWEEPS = 30


# -- strip mesh -------------------------------------------------------------

def strip_mesh(nx, ny, sx=0.0025, sy=0.05, grading=10.0):
    """The graded strip: (vertices (nv, 2), quads (ne, 4), boundary segments
    (nb, 2), their attributes (nb,): 1 bottom, 2 right, 3 top, 4 left).
    Cell heights shrink geometrically toward the top, the bottom cell
    ``grading`` times the top one; vertices row by row from the bottom,
    x fastest; cells likewise."""
    q = (1.0 / grading) ** (1.0 / max(ny - 1, 1))
    h = q ** np.arange(ny)
    ys = np.concatenate([[0.0], np.cumsum(h)]) * (sy / h.sum())
    ys[-1] = sy
    xs = np.linspace(0.0, sx, nx + 1)
    verts = np.stack([np.tile(xs, ny + 1), np.repeat(ys, nx + 1)], axis=1)
    vid = lambda i, j: j * (nx + 1) + i
    quads = np.array([[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                       vid(i, j + 1)] for j in range(ny) for i in range(nx)],
                     dtype=np.int64)
    segs, attrs = [], []
    for i in range(nx):
        segs += [[vid(i, 0), vid(i + 1, 0)], [vid(i, ny), vid(i + 1, ny)]]
        attrs += [1, 3]
    for j in range(ny):
        segs += [[vid(nx, j), vid(nx, j + 1)], [vid(0, j), vid(0, j + 1)]]
        attrs += [2, 4]
    return verts, quads, np.array(segs, dtype=np.int64), np.array(attrs)


def refine(verts, quads, segs, attrs):
    """One uniform refinement: each quad into four (edge midpoints, then
    the cell's centre, appended after the vertices in that order), each
    boundary segment into two with its attribute."""
    nv = len(verts)
    edges = {}
    new = [np.asarray(verts, dtype=np.float64)]

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in edges:
            edges[key] = nv + len(edges)
        return edges[key]

    e_ids = np.array([[mid(q[i], q[(i + 1) % 4]) for i in range(4)]
                      for q in quads])
    s_ids = np.array([mid(a, b) for a, b in segs])
    mids = np.zeros((len(edges), 2))
    for (a, b), i in edges.items():
        mids[i - nv] = 0.5 * (verts[a] + verts[b])
    c_ids = nv + len(edges) + np.arange(len(quads))
    centres = np.asarray(verts)[quads].mean(axis=1)
    q, e, c = np.asarray(quads), e_ids, c_ids
    fine = np.concatenate([
        np.stack([q[:, 0], e[:, 0], c, e[:, 3]], 1),
        np.stack([e[:, 0], q[:, 1], e[:, 1], c], 1),
        np.stack([c, e[:, 1], q[:, 2], e[:, 2]], 1),
        np.stack([e[:, 3], c, e[:, 2], q[:, 3]], 1)])
    fine_segs = np.concatenate([np.stack([segs[:, 0], s_ids], 1),
                                np.stack([s_ids, segs[:, 1]], 1)])
    return (np.concatenate(new + [mids, centres]), fine, fine_segs,
            np.concatenate([attrs, attrs]))


def write_gmsh(path, verts, quads, segs, attrs):
    """GMSH v2.2 ASCII: nodes, then boundary segments and quads, each with
    its physical attribute (quads 1)."""
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(len(verts))]
    lines += [f"{i + 1} {float(x)!r} {float(y)!r} 0"
              for i, (x, y) in enumerate(verts)]
    lines += ["$EndNodes", "$Elements", str(len(segs) + len(quads))]
    k = 1
    for s, a in zip(segs, attrs):
        lines.append(f"{k} 1 2 {a} {a} {s[0] + 1} {s[1] + 1}")
        k += 1
    for q in quads:
        lines.append(f"{k} 3 2 1 1 " + " ".join(str(v + 1) for v in q))
        k += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


# -- material ----------------------------------------------------------------

def natural_y2(x, y):
    """Second derivatives at the knots of the natural cubic spline through
    (x, y[k]) for each row k of y (n knots)."""
    n = len(x)
    h = np.diff(x)
    A = np.zeros((n, n))
    r = np.zeros((y.shape[0], n))
    A[0, 0] = A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1], A[i, i], A[i, i + 1] = h[i - 1], 2 * (h[i - 1] + h[i]), \
            h[i]
        r[:, i] = 6 * ((y[:, i + 1] - y[:, i]) / h[i]
                       - (y[:, i] - y[:, i - 1]) / h[i - 1])
    return np.linalg.solve(A, r.T).T


class Table:
    """Properties over (p, T): natural cubic splines in T per pressure
    level, linear in p between levels; T and p clamped to the table."""

    def __init__(self, node, nprop, device, dtype):
        levels = sorted(node["pressure_tables"], key=lambda t: float(t["p"]))
        self.ps = torch.tensor([float(t["p"]) for t in levels], dtype=dtype,
                               device=device)
        self.levels = []
        for t in levels:
            rows = np.array(sorted([float(v) for v in r[:nprop + 1]]
                                   for r in t["rows"]))
            x, y = rows[:, 0], rows[:, 1:].T
            tt = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
            self.levels.append((tt(x), tt(y), tt(natural_y2(x, y))))

    def _level(self, lvl, T):
        x, y, y2 = lvl
        Tq = torch.minimum(torch.maximum(T, x[0]), x[-1])
        k = torch.clamp(torch.searchsorted(x, Tq.detach().contiguous()),
                        1, len(x) - 1) - 1
        xl, xh = x[k], x[k + 1]
        hh = xh - xl
        a, b = (xh - Tq) / hh, (Tq - xl) / hh
        return (a * y[:, k] + b * y[:, k + 1]
                + ((a ** 3 - a) * y2[:, k] + (b ** 3 - b) * y2[:, k + 1])
                * hh * hh / 6.0)

    def __call__(self, p, T):
        """(nprop, ...) values at (p, T) of one shape."""
        vals = torch.stack([self._level(lvl, T) for lvl in self.levels])
        if len(self.levels) == 1:
            return vals[0]
        ps = self.ps
        pc = torch.minimum(torch.maximum(p, ps[0]), ps[-1])
        hi = torch.clamp(torch.searchsorted(ps, pc.detach().contiguous()),
                         1, len(ps) - 1)
        lo = hi - 1
        w = (pc - ps[lo]) / (ps[hi] - ps[lo])
        take = lambda i: torch.gather(
            vals, 0, torch.broadcast_to(i[None, None], (1,) + vals.shape[1:]))[0]
        return (1 - w) * take(lo) + w * take(hi)


class Material:
    def __init__(self, deck, device, dtype):
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                      dtype=dtype, device=device)
        c, ph, tr = deck["constants"], deck["phases"], deck["transport"]
        self.R = float(c["R"])
        self.min_pi = float(c.get("min_pi_pyro", 1e-9))
        rho_eps = np.array(ph["rhoI"], float) * np.array(ph["epsI"], float)
        reacs = deck["reactions"]
        phase = np.array([int(r["phase_index"]) if "phase_index" in r
                          else int(r["phase"]) - 1 for r in reacs])
        F = np.array([float(r["F"]) for r in reacs])
        self.F, self.phase = F, phase
        self.rho_eps = rho_eps
        self.A, self.E = t([r["A"] for r in reacs]), t([r["E"] for r in reacs])
        self.m, self.n = t([r["m"] for r in reacs]), t([r["n"] for r in reacs])
        self.T_thr = t([r["T_threshold"] for r in reacs])
        self.rho_v = float(rho_eps.sum())
        self.rho_c = float(max(rho_eps.sum() - (rho_eps[phase] * F).sum(),
                               1e-14))
        w = F * rho_eps[phase]
        self.tau_w = t(w / w.sum())
        self.pi_w = t(w)
        self.Fx = t(F)
        self.K_v, self.K_c = float(tr["K_v"]), float(tr["K_c"])
        self.eg_v, self.eg_c = float(tr["eps_g_v"]), float(tr["eps_g_c"])
        tabs = deck["tables"]
        self.virgin = Table(tabs["virgin"], 3, device, dtype)
        self.char = Table(tabs["char"], 3, device, dtype)
        self.gas = Table(tabs["gas"], 3, device, dtype)

    def extents(self, T, dt, X_old):
        """The extents (..., nr) of a step at temperatures T (...)."""
        x_old = torch.clamp(X_old, 0.0, 1.0)
        Tc = torch.clamp(T, min=1.0)[..., None]
        arr = self.A * torch.exp(-self.E / (self.R * Tc))
        tpow = torch.where(self.n == 0.0, 1.0,
                           torch.clamp(Tc, min=1e-14) ** self.n)
        active = (Tc >= self.T_thr) & (arr > 0.0) & (dt > 0.0)
        x = x_old
        for _ in range(EXTENT_SWEEPS):
            om = torch.clamp(1.0 - x, min=1e-14)
            xpow = torch.where(self.m == 0.0, 1.0, om ** self.m)
            dxpow = torch.where(self.m == 1.0, 1.0, om ** (self.m - 1.0))
            f = x - x_old - dt * arr * xpow * tpow
            dfdx = 1.0 + dt * arr * self.m * dxpow * tpow
            x = torch.where(active, torch.minimum(
                torch.maximum(x - f / torch.clamp(dfdx, min=1e-14), x_old),
                torch.ones_like(x)), x_old)
        return x

    def solid(self, T, p, X, X_old=None, dt=0.0):
        x = torch.clamp(X, 0.0, 1.0)
        tau = torch.clamp(torch.sum(self.tau_w * (1.0 - x), dim=-1), 0.0, 1.0)
        rho_s = torch.zeros_like(tau)
        for ph in range(len(self.rho_eps)):
            burnt = sum((float(self.F[i]) * x[..., i]
                         for i in np.nonzero(self.phase == ph)[0]),
                        torch.zeros_like(tau))
            rho_s = rho_s + float(self.rho_eps[ph]) * torch.clamp(
                1.0 - burnt, min=0.0)
        rho_ref = torch.clamp(rho_s, min=self.rho_c)
        vw = torch.where(rho_ref > 0, tau * self.rho_v / rho_ref, tau)
        cpv, hv, kv = self.virgin(p, T)
        cpc, hc, kc = self.char(p, T)
        out = {"tau": tau, "rho_s": rho_s,
               "cp": cpv * vw + cpc * (1 - vw), "k": kv * vw + kc * (1 - vw),
               "K": tau * self.K_v + (1 - tau) * self.K_c,
               "eps_g": tau * self.eg_v + (1 - tau) * self.eg_c}
        if X_old is None:
            out["pi"] = torch.zeros_like(tau)
        else:
            dX = torch.clamp(x - torch.clamp(X_old, 0.0, 1.0), min=0.0)
            pi = self.pi_w * dX / dt
            out["pi"] = torch.where(pi < self.min_pi, 0.0, pi).sum(dim=-1)
        h_bar = (self.rho_v * hv - self.rho_c * hc) / (self.rho_v - self.rho_c)
        out["sink"] = h_bar * out["pi"]
        return out

    def gas_props(self, T, p):
        M, h, mu = self.gas(p, T)
        return {"h": h, "mu": mu,
                "rho": p * M / (self.R * torch.clamp(T, min=1.0))}


# -- the step ------------------------------------------------------------------

def _q1_tables(device, dtype):
    """Bilinear basis values (9, 4) and reference gradients (9, 4, 2) at the
    3 x 3 Gauss points of [0, 1]^2, with their weights (9,)."""
    g, w = np.polynomial.legendre.leggauss(3)
    g, w = 0.5 * (g + 1.0), 0.5 * w
    X, Y = np.meshgrid(g, g, indexing="xy")
    xi, eta = X.ravel(), Y.ravel()
    W = np.outer(w, w).ravel()
    N = np.stack([(1 - xi) * (1 - eta), xi * (1 - eta), xi * eta,
                  (1 - xi) * eta], axis=1)
    dN = np.stack([np.stack([-(1 - eta), -(1 - xi)], 1),
                   np.stack([(1 - eta), -xi], 1),
                   np.stack([eta, xi], 1),
                   np.stack([-eta, (1 - xi)], 1)], axis=1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(N), t(dN), t(W)


class Case1Reference:
    def __init__(self, deck, verts, quads, top, device, dtype=torch.float64):
        self.device, self.dtype = device, dtype
        self.mat = Material(deck, device, dtype)
        self.quads = torch.as_tensor(quads, device=device)
        self.nv = len(verts)
        self.top = torch.as_tensor(np.asarray(top), device=device)
        N, dN, W = _q1_tables(device, dtype)
        xe = torch.as_tensor(verts, dtype=dtype, device=device)[self.quads]
        J = torch.einsum("qar,ead->eqdr", dN, xe)          # dx_d / dxi_r
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        inv = torch.stack([torch.stack([J[..., 1, 1], -J[..., 0, 1]], -1),
                           torch.stack([-J[..., 1, 0], J[..., 0, 0]], -1)],
                          -2) / det[..., None, None]        # dxi_r / dx_d
        self.N = N
        self.grad = torch.einsum("qar,eqrd->eqad", dN, inv)  # (ne, 9, 4, 2)
        self.wdet = W * det
        q = np.asarray(quads)
        self._rows = np.repeat(q, 4, axis=1).reshape(-1)
        self._cols = np.tile(q, (1, 4)).reshape(-1)
        mask = np.zeros(2 * self.nv, dtype=bool)
        mask[np.asarray(top)] = True
        mask[np.asarray(top) + self.nv] = True
        self.mask = mask
        self.mask_t = torch.as_tensor(mask, device=device)

    def at_qp(self, u):
        """Values at the quadrature points (ne, 9) of a vertex field."""
        return torch.einsum("qa,ea->eq", self.N, u.to(self.dtype)[self.quads])

    def advance(self, X_old, T, dt):
        """The extents (ne, 9, nr) of a step that ends at temperatures T."""
        return self.mat.extents(self.at_qp(T), dt, X_old)

    def _elem_res(self, dt):
        mat, N = self.mat, self.N

        def res(Te, pe, grad, wdet, To, po, Xo):
            Tq, pq = N @ Te, N @ pe
            gT = torch.einsum("qad,a->qd", grad, Te)
            gp = torch.einsum("qad,a->qd", grad, pe)
            X = mat.extents(Tq, dt, Xo)
            s = mat.solid(Tq, pq, X, Xo, dt)
            g = mat.gas_props(Tq, pq)
            so, go = mat.solid(To, po, Xo), mat.gas_props(To, po)
            rd = g["rho"] * s["K"] / torch.clamp(g["mu"], min=MU_FLOOR)
            r0p = (s["eps_g"] * g["rho"] - so["eps_g"] * go["rho"]) / dt \
                - s["pi"]
            r1p = rd[:, None] * gp
            r0T = (s["rho_s"] * s["cp"] * (Tq - To)
                   + s["eps_g"] * (g["rho"] * g["h"] - pq)
                   - so["eps_g"] * (go["rho"] * go["h"] - po)) / dt - s["sink"]
            r1T = s["k"][:, None] * gT + (g["h"] * rd)[:, None] * gp
            pair = lambda r0, r1: (N.T @ (r0 * wdet)
                                   + torch.einsum("qad,qd->a", grad,
                                                  r1 * wdet[:, None]))
            return pair(r0T, r1T), pair(r0p, r1p)

        return res

    def residual(self, T, p, To_q, po_q, Xo, dt):
        """The masked global residual (2 nv,) of a step."""
        res = torch.func.vmap(self._elem_res(dt))
        rT, rp = res(T[self.quads], p[self.quads], self.grad, self.wdet,
                     To_q, po_q, Xo)
        R = torch.zeros(2 * self.nv, dtype=self.dtype, device=self.device)
        R.index_add_(0, self.quads.reshape(-1), rT.reshape(-1))
        R.index_add_(0, self.quads.reshape(-1) + self.nv, rp.reshape(-1))
        return torch.where(self.mask_t, 0.0, R)

    def jacobian(self, T, p, To_q, po_q, Xo, dt):
        jac = torch.func.vmap(torch.func.jacfwd(self._elem_res(dt),
                                                argnums=(0, 1)))
        (JTT, JTp), (JpT, Jpp) = jac(T[self.quads], p[self.quads], self.grad,
                                     self.wdet, To_q, po_q, Xo)
        n = self.nv
        r, c = self._rows, self._cols
        rows = np.concatenate([r, r, r + n, r + n])
        cols = np.concatenate([c, c + n, c, c + n])
        vals = torch.cat([b.reshape(-1) for b in (JTT, JTp, JpT, Jpp)])
        J = sp.coo_matrix((vals.cpu().numpy(), (rows, cols)),
                          shape=(2 * n, 2 * n)).tocsr()
        keep = sp.diags((~self.mask).astype(J.dtype))
        return keep @ J @ keep + sp.diags(self.mask.astype(J.dtype))

    def newton(self, T_old, p_old, X_old, dt, T_wall, p_top, max_iter=60):
        """The step's (T, p, iterations) from the previous state: Newton
        from the previous fields with the step's Dirichlet values, until
        the update is below 1e-10 of the fields' magnitude (100 eps of a
        lower precision, where that is more).  The Jacobian and its LU are
        kept while each update is below a quarter of the one before, and
        formed again at the next iteration where it is not (a chord
        iteration that contracts too slowly)."""
        T = T_old.to(self.dtype).clone()
        p = p_old.to(self.dtype).clone()
        T[self.top], p[self.top] = T_wall, p_top
        To_q, po_q = self.at_qp(T_old), self.at_qp(p_old)
        Xo = X_old.to(self.dtype)
        n = self.nv
        tol = max(1e-10, 100 * torch.finfo(self.dtype).eps)
        lu, last = None, None
        for it in range(1, max_iter + 1):
            R = self.residual(T, p, To_q, po_q, Xo, dt)
            if lu is None:
                J = self.jacobian(T, p, To_q, po_q, Xo, dt)
                # rows, then columns, scaled to unit largest entries
                dr = 1.0 / abs(J).max(axis=1).toarray().ravel()
                Js = sp.diags(dr) @ J
                dc = 1.0 / abs(Js).max(axis=0).toarray().ravel()
                Js = (Js @ sp.diags(dc)).astype(J.dtype)
                lu = spla.splu(Js.tocsc())
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
