"""TACOT charring-ablator material model (PATO-style) in PyTorch.

Port of ``cmfem_tpu/physics/tacot.py`` (the reference's ``TACOTMaterial``):

- per-QP Arrhenius reaction extents advanced by an implicit scalar Newton,
  a ``torch.autograd.Function`` whose forward-mode derivative is the
  implicit-function-theorem tangent of the converged solution (zero where
  the extent sits on its x in [x_old, 1] clamp, the reference's
  frozen-derivative semantics); it carries a ``vmap`` rule, so the element
  Jacobians run it under ``torch.func.vmap(torch.func.jacfwd(...))``;
- virgin/char property blending by the virgin-mass fraction tau;
- ideal-gas properties from tables;
- natural cubic splines in T per pressure level, linear in p with clamping.

The spline interval is found by ``torch.searchsorted`` on a detached copy
of the query plus a gather.  The JAX package contracts an interval one-hot
instead (and chunks it through ``lax.map``): gathers scalarize on the TPU,
not here.  The derivative flows through the cubic's value formula only, as
there.

Every method takes tensors of any leading shape and returns tensors on
their device in their dtype.  The loader is numpy; ``load_yaml`` reads a
``.json`` deck with the standard library and imports PyYAML only for YAML.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.timing import host_copy, host_sync


def natural_spline_y2(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives of the natural cubic spline through (x, y).

    y may have leading batch dims (..., n). Thomas-algorithm sweep with
    natural (zero second derivative) end conditions."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[-1]
    y2 = np.zeros_like(y)
    if n < 3:
        return y2
    u = np.zeros(y.shape[:-1] + (n - 1,))
    for i in range(1, n - 1):
        sig = (x[i] - x[i - 1]) / (x[i + 1] - x[i - 1])
        p = sig * y2[..., i - 1] + 2.0
        y2[..., i] = (sig - 1.0) / p
        dy1 = (y[..., i + 1] - y[..., i]) / (x[i + 1] - x[i])
        dy0 = (y[..., i] - y[..., i - 1]) / (x[i] - x[i - 1])
        u[..., i] = (6.0 * (dy1 - dy0) / (x[i + 1] - x[i - 1])
                     - sig * u[..., i - 1]) / p
    y2[..., n - 1] = 0.0
    for k in range(n - 2, -1, -1):
        y2[..., k] = y2[..., k] * y2[..., k + 1] + u[..., k]
    return y2


def _interval(x, xq):
    """Interval index k (n-1 intervals) of each query: searchsorted-left
    (#{i: x[i] < xq}) clipped to [1, n-1], minus one.  Computed from a
    detached copy, so no transform differentiates or batches through an
    integer result."""
    n = x.shape[0]
    ss = torch.searchsorted(x, xq.detach().contiguous())
    return torch.clamp(ss, 1, n - 1) - 1


def _cubic(x, xq, k, ylo, yhi, y2lo, y2hi):
    """Value and T-derivative of the cubic on interval k."""
    xlo, xhi = x[k], x[k + 1]
    h = xhi - xlo
    a = (xhi - xq) / h
    b = (xq - xlo) / h
    val = (a * ylo + b * yhi
           + ((a ** 3 - a) * y2lo + (b ** 3 - b) * y2hi) * (h * h) / 6.0)
    der = ((yhi - ylo) / h
           + (h / 6.0) * (-(3 * a * a - 1) * y2lo + (3 * b * b - 1) * y2hi))
    return val, der


def spline_eval(x, y, y2, xq):
    """Evaluate natural cubic splines with end-clamping.

    x (nT,), y/y2 (nT,) or (..., nT) aligned with the query xq (...,).
    Returns (value, deriv, clamped); outside [x0, xN] the end value is
    returned with deriv = 0 (reference EvalClampWithDerivative)."""
    x = torch.as_tensor(x, dtype=xq.dtype, device=xq.device)
    y = torch.as_tensor(y, dtype=xq.dtype, device=xq.device)
    y2 = torch.as_tensor(y2, dtype=xq.dtype, device=xq.device)
    k = _interval(x, xq)
    if y.ndim == 1:
        ylo, yhi, y2lo, y2hi = y[k], y[k + 1], y2[k], y2[k + 1]
        y_first, y_last = y[0], y[-1]
    else:
        take = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]
        ylo, yhi, y2lo, y2hi = take(y, k), take(y, k + 1), take(y2, k), \
            take(y2, k + 1)
        y_first, y_last = y[..., 0], y[..., -1]
    val, der = _cubic(x, xq, k, ylo, yhi, y2lo, y2hi)
    lo_clamp = xq <= x[0]
    hi_clamp = xq >= x[-1]
    val = torch.where(lo_clamp, y_first, val)
    val = torch.where(hi_clamp, y_last, val)
    clamped = lo_clamp | hi_clamp
    der = torch.where(clamped, 0.0, der)
    return val, der, clamped


def _spline_eval_levels(x, ys, y2s, xq):
    """L splines sharing one knot grid at the same queries: x (nT,), ys/y2s
    (L, nT), xq (...,) -> (val, der, clamped), each (L, ...).  One interval
    search, then a gather per level table."""
    k = _interval(x, xq)
    val, der = _cubic(x, xq, k, ys[:, k], ys[:, k + 1], y2s[:, k],
                      y2s[:, k + 1])
    lo_clamp = xq <= x[0]
    hi_clamp = xq >= x[-1]
    shape1 = (ys.shape[0],) + (1,) * xq.ndim
    val = torch.where(lo_clamp, ys[:, 0].reshape(shape1), val)
    val = torch.where(hi_clamp, ys[:, -1].reshape(shape1), val)
    clamped = lo_clamp | hi_clamp
    der = torch.where(clamped, 0.0, der)
    return val, der, torch.broadcast_to(clamped, val.shape)


class _DeviceCache:
    """Tensor copies of numpy constants, one per (name, device, dtype)."""

    def __init__(self):
        self._c = {}

    def get(self, name, arr, like):
        key = (name, like.device, like.dtype)
        if key not in self._c:
            host_sync()
            self._c[key] = torch.as_tensor(np.asarray(arr), dtype=like.dtype,
                                           device=like.device)
        return self._c[key]

    def __reduce__(self):
        # a copy (a pickle to another process) starts empty: the entries
        # are made again from the numpy constants at first use
        return (_DeviceCache, ())


@dataclass
class PropertyTable:
    """(p, T) property table: splines in T per pressure level, linear in p.

    p_levels (L,), T_tab (L, nTmax) per-level T knots — ragged per-level
    rows supported; shorter levels are padded with a monotone knot
    extension carrying the end value (y2=0), and evaluation clamps the query
    to each level's true range so padding is never reached.  T_hi (L,) true
    top knot, y (L, nprop, nTmax), y2 same."""

    p_levels: np.ndarray
    T_tab: np.ndarray
    T_hi: np.ndarray
    y: np.ndarray
    y2: np.ndarray
    log_p: bool = False
    uniform: bool = True
    _dev: _DeviceCache = field(default_factory=_DeviceCache, repr=False,
                               compare=False)

    @property
    def T(self):
        """Shared T grid for uniform tables; level 0's knots otherwise."""
        return self.T_tab[0]

    @classmethod
    def from_yaml_node(cls, node: dict, nprop: int) -> "PropertyTable":
        levels = sorted(node["pressure_tables"], key=lambda t: float(t["p"]))
        ps = np.array([float(t["p"]) for t in levels])
        grids = []
        ys = []
        for t in levels:
            rows = sorted(([float(v) for v in r] for r in t["rows"]),
                          key=lambda r: r[0])
            rows = np.asarray(rows)
            if rows.shape[1] < nprop + 1:
                raise ValueError("Malformed table row")
            if rows.shape[0] < 2:
                raise ValueError("Each pressure level needs >= 2 T rows")
            grids.append(rows[:, 0])
            ys.append(rows[:, 1:nprop + 1].T)  # (nprop, nTl)
        nTmax = max(len(g) for g in grids)
        L = len(ps)
        T_tab = np.zeros((L, nTmax))
        T_hi = np.zeros(L)
        y = np.zeros((L, nprop, nTmax))
        y2 = np.zeros((L, nprop, nTmax))
        uniform = True
        for i, (Tg, yi) in enumerate(zip(grids, ys)):
            nTl = len(Tg)
            npad = nTmax - nTl
            uniform &= (nTl == len(grids[0])
                        and bool(np.allclose(Tg, grids[0])))
            T_hi[i] = Tg[-1]
            dpad = Tg[-1] - Tg[-2]
            T_tab[i] = np.concatenate(
                [Tg, Tg[-1] + dpad * np.arange(1, npad + 1)])
            y[i, :, :nTl] = yi
            y[i, :, nTl:] = yi[:, -1:]
            y2[i, :, :nTl] = natural_spline_y2(Tg, yi)
        return cls(ps, T_tab, T_hi, y, y2, uniform=uniform)

    def eval(self, prop_idx: int, p, T, with_derivs: bool = False):
        """Batched evaluation; returns value or (value, dp, dT, clamped_p,
        clamped_T)."""
        return self.eval_props((prop_idx,), p, T, with_derivs)[0]

    def eval_props(self, prop_idxs, p, T, with_derivs: bool = False):
        """Evaluate several properties of this table at the same (p, T)
        queries; returns a list aligned with ``prop_idxs``.  The semantics
        of the JAX package's ``eval_props``: pressure clamped to the level
        range, the exact-interior-level match taking the forward interval,
        ``dp`` zero where p is clamped."""
        idxs = list(prop_idxs)
        P = len(idxs)
        L = len(self.p_levels)
        T = torch.as_tensor(T)
        p = torch.as_tensor(p, dtype=T.dtype, device=T.device)
        T, p = torch.broadcast_tensors(T, p)
        key = tuple(idxs)
        yj = self._dev.get(("y", key), self.y[:, idxs], T)     # (L, P, nT)
        y2j = self._dev.get(("y2", key), self.y2[:, idxs], T)
        nTmax = yj.shape[-1]

        if self.uniform:
            v, d, c = _spline_eval_levels(
                self._dev.get("T0", self.T_tab[0], T),
                yj.reshape(L * P, nTmax), y2j.reshape(L * P, nTmax), T)
            shp = (L, P) + v.shape[1:]
            vals, ders, Tcl = v.reshape(shp), d.reshape(shp), c.reshape(shp)
        else:
            T_tab = self._dev.get("T_tab", self.T_tab, T)
            vs, ds, cs = [], [], []
            for lvl in range(L):
                lo, hi = float(self.T_tab[lvl, 0]), float(self.T_hi[lvl])
                Tq = torch.clamp(T, lo, hi)
                v, d, _ = _spline_eval_levels(T_tab[lvl], yj[lvl], y2j[lvl],
                                              Tq)
                c = (T <= lo) | (T >= hi)
                vs.append(v)
                ds.append(torch.where(c, 0.0, d))
                cs.append(torch.broadcast_to(c, v.shape))
            vals, ders, Tcl = torch.stack(vs), torch.stack(ds), \
                torch.stack(cs)

        if L == 1:
            if not with_derivs:
                return [vals[0, i] for i in range(P)]
            z = torch.zeros_like(vals[0, 0])
            nope = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
            return [(vals[0, i], z, ders[0, i], nope, Tcl[0, i])
                    for i in range(P)]

        ps = self._dev.get("ps", self.p_levels, T)
        pc = torch.clamp(p, float(self.p_levels[0]), float(self.p_levels[-1]))
        clamped_p = (p <= ps[0]) | (p >= ps[-1])
        hi0 = torch.clamp(torch.searchsorted(ps, pc.detach().contiguous()),
                          1, L - 1)
        # exact interior match -> forward interval (reference :829-840)
        p_tol = 1e-12 * torch.clamp(torch.abs(pc), min=1.0)
        exact_int = (torch.abs(ps[hi0] - pc) <= p_tol) & (hi0 < L - 1) \
            & (~clamped_p)
        lo = torch.where(exact_int, hi0, hi0 - 1)
        hi = torch.where(exact_int, hi0 + 1, hi0)
        p0, p1 = ps[lo], ps[hi]
        w = (pc - p0) / (p1 - p0)

        def take(arr, lvl):
            # (L, P, ...) at a per-query level index (...) -> (P, ...)
            idx = torch.broadcast_to(lvl[None, None], (1,) + arr.shape[1:])
            return torch.gather(arr, 0, idx)[0]

        v0, v1 = take(vals, lo), take(vals, hi)
        d0, d1 = take(ders, lo), take(ders, hi)
        value = (1 - w) * v0 + w * v1
        dT = (1 - w) * d0 + w * d1
        if not with_derivs:
            return [value[i] for i in range(P)]
        cT = take(Tcl, lo) | take(Tcl, hi)
        dp = torch.where(clamped_p, 0.0, (v1 - v0) / (p1 - p0))
        return [(value[i], dp[i], dT[i], clamped_p, cT[i]) for i in range(P)]


class _Rates:
    """The reaction constants of a material as tensors of one device and
    dtype, and the pieces of the extent equation."""

    def __init__(self, mat: "TacotMaterial", like):
        c = lambda name, a: mat._dev.get(name, a, like)
        self.A, self.E = c("A", mat.A), c("E", mat.E)
        self.m_exp, self.n_exp = c("m_exp", mat.m_exp), c("n_exp", mat.n_exp)
        self.T_thr = c("T_thr", mat.T_thr)
        self.R = mat.R

    def pieces(self, T, x):
        Tc = torch.clamp(T, min=1.0)[..., None]
        arr = self.A * torch.exp(-self.E / (self.R * Tc))
        tpow = torch.where(self.n_exp == 0.0, 1.0,
                           torch.clamp(Tc, min=1e-14) ** self.n_exp)
        one_minus = torch.clamp(1.0 - x, min=1e-14)
        xpow = torch.where(self.m_exp == 0.0, 1.0, one_minus ** self.m_exp)
        dxpow = torch.where(self.m_exp == 1.0, 1.0,
                            one_minus ** (self.m_exp - 1.0))
        return Tc, arr, tpow, xpow, dxpow

    def active(self, Tc, arr, dt):
        return (Tc >= self.T_thr) & (arr > 0.0) & (dt > 0.0)


def _batch_front(t, bdim, size):
    """t with its batch dimension moved to the front (or a broadcast one
    added), so the elementwise extent solve sees one leading batch axis."""
    if bdim is None:
        return t.expand((size,) + t.shape) if t.ndim else t.expand(size)
    return t.movedim(bdim, 0)


def _extent_sweeps(rt, T, dtb, x_old, arr, tpow, active, iters, frozen):
    """The extent equation's Newton sweeps from ``x_old``: at most ``iters``,
    the last the first whose largest change is not above 100 eps of the
    dtype (a NaN change stops too).  Eager, the host reads each sweep's
    change and stops there; ``frozen`` runs every sweep with no wait, a
    device flag set at that sweep holding x from then on, which gives the
    same x bit for bit (what a CUDA graph capture needs)."""
    tol = 100.0 * torch.finfo(T.dtype).eps
    x = x_old
    done = None
    if frozen and x.numel():
        done = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(iters):
        _, _, _, xpow, dxpow = rt.pieces(T, x)
        rate = arr * xpow * tpow
        f = x - x_old - dtb * rate
        dfdx = 1.0 + dtb * arr * rt.m_exp * dxpow * tpow
        dx = f / torch.clamp(dfdx, min=1e-14)
        x_new = torch.where(active,
                            torch.minimum(torch.maximum(x - dx, x_old),
                                          torch.ones_like(x)), x_old)
        delta = torch.max(torch.abs(x_new - x)) if x.numel() else 0.0
        if done is not None:
            x = torch.where(done, x, x_new)
            done = done | ~(delta > tol)
            continue
        x = x_new
        if torch.is_tensor(delta):
            host_sync()
        if not bool(delta > tol):
            break
    return x


class _ExtentSolve(torch.autograd.Function):
    """x = solve(T, dt, x_old): the backward-Euler extent equation
    x - x_old - dt rate(x, T) = 0 by a convergence-gated Newton (at most
    ``newton_iters`` sweeps, tolerance 100 eps of the dtype, x kept in
    [x_old, 1]), with the IFT tangent as its forward-mode derivative."""

    @staticmethod
    def forward(T, dt, extent_old, mat):
        rt = _Rates(mat, T)
        x_old = torch.clamp(extent_old, 0.0, 1.0)
        host_copy(dt, T.device)
        dt = torch.as_tensor(dt, dtype=T.dtype, device=T.device)
        dtb = dt.reshape(dt.shape + (1,) * (x_old.ndim - dt.ndim)) \
            if dt.ndim else dt
        Tc, arr, tpow, _, _ = rt.pieces(T, x_old)
        active = rt.active(Tc, arr, dtb)
        # a CUDA graph capture may not wait for the device
        frozen = T.is_cuda and torch.cuda.is_current_stream_capturing()
        x = _extent_sweeps(rt, T, dtb, x_old, arr, tpow, active,
                           mat.newton_iters, frozen)
        return torch.minimum(torch.maximum(torch.where(active, x, x_old),
                                           x_old), torch.ones_like(x))

    @staticmethod
    def setup_context(ctx, inputs, output):
        T, dt, extent_old, mat = inputs
        ctx.mat = mat
        ctx.dt = dt
        ctx.save_for_forward(T, output, extent_old)

    @staticmethod
    def jvp(ctx, dT, ddt, dx_old_t, _):
        """IFT derivative of the converged extents: from
        f(x, T) = x - x_old - dt*rate(x, T) = 0,
          dx/dT = dt (dr/dT) / dfdx, dx/dx_old = 1/dfdx, dx/ddt = rate/dfdx;
        zeroed where the solution sits on a clamp."""
        T, x, extent_old = ctx.saved_tensors
        rt = _Rates(ctx.mat, T)
        host_copy(ctx.dt, T.device)
        dt = torch.as_tensor(ctx.dt, dtype=T.dtype, device=T.device)
        dtb = dt.reshape(dt.shape + (1,) * (x.ndim - dt.ndim)) \
            if dt.ndim else dt
        Tc, arr, tpow, xpow, dxpow = rt.pieces(T, x)
        rate = arr * xpow * tpow
        darr_dT = arr * (rt.E / (rt.R * Tc * Tc))
        dtpow_dT = torch.where(
            rt.n_exp == 0.0, 0.0,
            rt.n_exp * torch.clamp(Tc, min=1e-14) ** (rt.n_exp - 1.0))
        drate_dT = (darr_dT * xpow * tpow + arr * xpow * dtpow_dT) * \
            torch.where(T > 1.0, 1.0, 0.0)[..., None]
        dfdx = 1.0 + dtb * arr * rt.m_exp * dxpow * tpow
        active = rt.active(Tc, arr, dtb)
        interior = active & (x < 1.0 - 1e-12)
        # non-interior splits: inactive passthrough (x == x_old, unit
        # derivative) vs active-but-clamped at x == 1 (pinned, derivative 0)
        out = torch.zeros_like(x)
        if dT is not None:
            out = out + torch.where(interior, dtb * drate_dT / dfdx,
                                    0.0) * dT[..., None]
        if dx_old_t is not None:
            out = out + torch.where(interior, 1.0 / dfdx,
                                    torch.where(active, 0.0, 1.0)) * dx_old_t
        if ddt is not None:
            ddtb = ddt.reshape(ddt.shape + (1,) * (x.ndim - ddt.ndim)) \
                if ddt.ndim else ddt
            out = out + torch.where(interior, rate / dfdx, 0.0) * ddtb
        return out

    @staticmethod
    def vmap(info, in_dims, T, dt, extent_old, mat):
        # elementwise: every batched input gets its batch axis in front,
        # unbatched ones a broadcast axis, then the whole batch solves at once
        B = info.batch_size
        Tb = _batch_front(T, in_dims[0], B)
        Xb = _batch_front(extent_old, in_dims[2], B)
        lead = torch.broadcast_shapes(Tb.shape, Xb.shape[:-1])
        Tb = Tb.expand(lead)
        Xb = Xb.expand(lead + Xb.shape[-1:])
        if torch.is_tensor(dt) and in_dims[1] is not None:
            dt = _batch_front(dt, in_dims[1], B)
        return _ExtentSolve.apply(Tb, dt, Xb, mat), 0


def _parse_pato_optics(path: str):
    """Parse a PATO surface property file into a 2-property (emissivity,
    reflectivity) PropertyTable.  Columns: p T cp h ki kj kk emissivity
    reflectivity; ``//`` comments; rows grouped by pressure."""
    if not os.path.isfile(path):
        return None
    grouped: dict = {}
    with open(path) as f:
        for line in f:
            line = line.split("//")[0]
            parts = line.split()
            if len(parts) < 9:
                continue
            try:
                vals = [float(v) for v in parts[:9]]
            except ValueError:
                continue
            p, T = vals[0], vals[1]
            grouped.setdefault(p, []).append((T, vals[7], vals[8]))
    if not grouped:
        return None
    node = {"pressure_tables": [
        {"p": p, "rows": sorted(rows)} for p, rows in sorted(grouped.items())
    ]}
    return PropertyTable.from_yaml_node(node, 2)


@dataclass
class TacotMaterial:
    """Loaded TACOT deck; the methods take and return torch tensors."""

    R: float
    min_pi_pyro: float
    rho_eps0: np.ndarray      # (nph,)
    K_v: float
    K_c: float
    eps_g_v: float
    eps_g_c: float
    F: np.ndarray             # (nr,)
    A: np.ndarray
    E: np.ndarray
    m_exp: np.ndarray
    n_exp: np.ndarray
    T_thr: np.ndarray
    h_reac: np.ndarray
    phase: np.ndarray         # (nr,) int
    virgin: PropertyTable
    char: PropertyTable
    gas: PropertyTable
    emissivity_fallback: float = 0.85
    reflectivity_fallback: float = 0.15
    newton_iters: int = 30
    # optional PATO surface-optics (p,T) tables: emissivity + reflectivity
    # per virgin/char state; None -> the 0.85/0.15 fallback
    virgin_optics: PropertyTable | None = None
    char_optics: PropertyTable | None = None
    _dev: _DeviceCache = field(default_factory=_DeviceCache, repr=False,
                               compare=False)

    @classmethod
    def load_yaml(cls, path: str) -> "TacotMaterial":
        """Load a deck: ``.json`` with the standard library (JSON is a subset
        of YAML, so the JAX package's loader reads the same file), anything
        else with PyYAML, imported here."""
        with open(path) as f:
            if path.lower().endswith(".json"):
                root = json.load(f)
            else:
                import yaml

                root = yaml.safe_load(f)
        return cls.from_mapping(root)

    @classmethod
    def from_mapping(cls, root: dict) -> "TacotMaterial":
        """The deck's parsed mapping -> TacotMaterial (the body of the JAX
        package's ``load_yaml``)."""
        for key in ("constants", "phases", "transport", "reactions", "tables"):
            if key not in root:
                raise ValueError(
                    "Material YAML must define constants, phases, transport, "
                    "reactions, and tables.")
        c = root["constants"]
        ph = root["phases"]
        tr = root["transport"]
        rhoI = np.array([float(v) for v in ph["rhoI"]])
        epsI = np.array([float(v) for v in ph["epsI"]])
        if len(rhoI) < 2 or len(epsI) < 2:
            raise ValueError("phases.rhoI and phases.epsI need >= 2 entries")
        nph = min(len(rhoI), len(epsI))
        reacs = root["reactions"]
        if not reacs:
            raise ValueError("Material YAML must contain at least one reaction.")

        def phase_of(r):
            if "phase_index" in r:
                return int(r["phase_index"])
            if "phase" in r:
                return int(r["phase"]) - 1
            return min(1, nph - 1)

        F = np.array([float(r["F"]) for r in reacs])
        if F.sum() <= 0:
            raise ValueError("Sum of reaction F coefficients must be positive.")
        return cls(
            R=float(c["R"]),
            min_pi_pyro=float(c.get("min_pi_pyro", 1.0e-9)),
            rho_eps0=(rhoI[:nph] * epsI[:nph]),
            K_v=float(tr["K_v"]), K_c=float(tr["K_c"]),
            eps_g_v=float(tr["eps_g_v"]), eps_g_c=float(tr["eps_g_c"]),
            F=F,
            A=np.array([float(r["A"]) for r in reacs]),
            E=np.array([float(r["E"]) for r in reacs]),
            m_exp=np.array([float(r["m"]) for r in reacs]),
            n_exp=np.array([float(r["n"]) for r in reacs]),
            T_thr=np.array([float(r["T_threshold"]) for r in reacs]),
            h_reac=np.array([float(r["h"]) for r in reacs]),
            phase=np.array([min(max(phase_of(r), 0), nph - 1) for r in reacs]),
            virgin=PropertyTable.from_yaml_node(root["tables"]["virgin"], 3),
            char=PropertyTable.from_yaml_node(root["tables"]["char"], 3),
            gas=PropertyTable.from_yaml_node(root["tables"]["gas"], 3),
            **cls._load_surface_optics(root),
        )

    @staticmethod
    def _load_surface_optics(root) -> dict:
        """Optional PATO surface-optics: ``source: path:`` names a PATO
        material directory whose ``virgin``/``char`` files carry 9 columns
        (p T cp h ki kj kk emissivity reflectivity).  Both must parse or
        neither is used."""
        src = (root.get("source") or {}).get("path")
        if not src:
            return {}
        try:
            v = _parse_pato_optics(os.path.join(src, "virgin"))
            c = _parse_pato_optics(os.path.join(src, "char"))
        except (OSError, ValueError):
            return {}
        if v is None or c is None:
            return {}
        return {"virgin_optics": v, "char_optics": c}

    # -- derived scalars ---------------------------------------------------

    @property
    def num_reactions(self) -> int:
        return len(self.F)

    @property
    def rho_virgin(self) -> float:
        return float(self.rho_eps0.sum())

    @property
    def rho_char(self) -> float:
        rc = self.rho_eps0.sum() - (self.rho_eps0[self.phase] * self.F).sum()
        return float(max(rc, 1e-14))

    def initial_solid_density(self) -> float:
        """solid_density at zero extent (the all-phase sum)."""
        return self.rho_virgin

    def char_solid_density(self) -> float:
        """solid_density at full extent (the per-reaction phase-indexed
        form)."""
        return self.rho_char

    # -- reaction extents --------------------------------------------------

    def solve_reaction_extents(self, T, dt, extent_old):
        """Advance extents by implicit backward Euler: x = x_old + dt*rate(x).

        T (...,), dt scalar, extent_old (..., nr) -> extent (..., nr).
        Convergence-gated Newton (at most 30 sweeps, the reference's cap)
        with the clamp x in [x_old, 1]; forward-differentiable through the
        implicit-function theorem."""
        return _ExtentSolve.apply(T, dt, extent_old, self)

    # -- bulk properties ---------------------------------------------------

    def tau(self, extent):
        """Virgin-mass fraction weighting (ComputeTau)."""
        w = self.F * self.rho_eps0[self.phase]
        norm = w.sum()
        if norm <= 0:
            return torch.ones(extent.shape[:-1], dtype=extent.dtype,
                              device=extent.device)
        wn = self._dev.get("tau_w", w / norm, extent)
        t = torch.sum(wn * (1.0 - torch.clamp(extent, 0.0, 1.0)), dim=-1)
        return torch.clamp(t, 0.0, 1.0)

    def solid_density(self, extent):
        x = torch.clamp(extent, 0.0, 1.0)
        fx = self._dev.get("F", self.F, extent) * x
        # phase_factor[ph] = 1 - sum_{i in ph} F_i x_i
        out = torch.zeros(extent.shape[:-1], dtype=extent.dtype,
                          device=extent.device)
        for ph in range(len(self.rho_eps0)):
            contrib = torch.zeros_like(out)
            for i in np.nonzero(self.phase == ph)[0]:
                contrib = contrib + fx[..., int(i)]
            out = out + float(self.rho_eps0[ph]) * torch.clamp(
                1.0 - contrib, min=0.0)
        return out

    def solid_props(self, T, p, extent, extent_old=None, dt=0.0):
        """EvaluateSolid; returns a dict of batched tensors."""
        tau = self.tau(extent)
        rho_s = self.solid_density(extent)
        rho_v = self.rho_virgin
        rho_c = self.rho_char
        rho_ref = torch.clamp(rho_s, min=rho_c)
        vw = torch.where(rho_ref > 0, tau * rho_v / rho_ref, tau)

        cp_v, h_v, k_v = self.virgin.eval_props((0, 1, 2), p, T)
        cp_c, h_c, k_c = self.char.eval_props((0, 1, 2), p, T)

        out = {
            "tau": tau,
            "rho_s": rho_s,
            "cp": cp_v * vw + cp_c * (1 - vw),
            "h": h_v * vw + h_c * (1 - vw),
            "k": k_v * vw + k_c * (1 - vw),
        }
        if self.virgin_optics is not None and self.char_optics is not None:
            eps_v, refl_v = self.virgin_optics.eval_props((0, 1), p, T)
            eps_c, refl_c = self.char_optics.eval_props((0, 1), p, T)
            out["emissivity"] = torch.clamp(eps_v * vw + eps_c * (1 - vw),
                                            0.0, 1.0)
            out["reflectivity"] = torch.clamp(
                refl_v * vw + refl_c * (1 - vw), 0.0, 1.0)
        else:
            out["emissivity"] = torch.full_like(tau, self.emissivity_fallback)
            out["reflectivity"] = torch.full_like(tau,
                                                  self.reflectivity_fallback)
        out["absorptivity"] = torch.clamp(1.0 - out["reflectivity"], 0.0, 1.0)
        out["K"] = tau * self.K_v + (1 - tau) * self.K_c
        out["eps_g"] = tau * self.eps_g_v + (1 - tau) * self.eps_g_c

        if extent_old is not None:
            x = torch.clamp(extent, 0.0, 1.0)
            xo = torch.clamp(extent_old, 0.0, 1.0)
            dX = torch.clamp(x - xo, min=0.0)
            w = self._dev.get("pi_w", self.rho_eps0[self.phase] * self.F,
                              extent)
            host_copy(dt, x.device)
            dt_t = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
            pi = torch.where(dt_t > 0,
                             w * dX / torch.clamp(dt_t, min=1e-300), 0.0)
            pi = torch.where(pi < self.min_pi_pyro, 0.0, pi)
            out["pi_i"] = pi
            out["pi_total"] = pi.sum(dim=-1)
        else:
            out["pi_i"] = torch.zeros(tau.shape + (self.num_reactions,),
                                      dtype=tau.dtype, device=tau.device)
            out["pi_total"] = torch.zeros_like(tau)

        if abs(rho_v - rho_c) > 1e-14:
            h_bar = (rho_v * h_v - rho_c * h_c) / (rho_v - rho_c)
        else:
            h_bar = h_v
        out["pyrolysis_heat_sink"] = h_bar * out["pi_total"]
        out["m_dot_g"] = out["pi_total"]
        return out

    def gas_props(self, T, p):
        """EvaluateGas."""
        M, h, mu = self.gas.eval_props((0, 1, 2), p, T)
        rho = p * M / (self.R * torch.clamp(T, min=1.0))
        return {"M": M, "h": h, "mu": mu, "rho": rho}
