"""B' surface-thermochemistry table: 3-axis (p, B'g, T) lookup.

Port of ``cmfem_tpu/physics/bprime.py`` (the reference's ``BPrimeTable``):
whitespace table parsing grouping p -> B'g -> (T, B'c, h_w) rows, natural
cubic splines in T per (p, B'g) level, linear interpolation in B'g,
log-linear in p, derivatives d/dB'g and d/dT with clamp and
non-smoothness flags, and mutable clamp statistics (``ClampStats``).

The loaders are numpy, as in the JAX package; levels are stored as padded
(Lp, Lbg, nTmax) arrays and each level evaluates on its own T knots
(ragged tables).  ``lookup`` is torch, differentiable in (B'g, T) under
``torch.func`` transforms.  Where the JAX package selects the B'g and p
intervals by one-hot contractions (gathers scalarize on the TPU), the
port finds them with ``torch.searchsorted`` on detached values and
gathers, so the derivative flows through the weights only, as there.
A uniform table (every level on one T grid) evaluates all its levels with
one interval search (``tacot._spline_eval_levels``).  The level tables,
the axes and the log floor go to a device once, into the table's
``tacot._DeviceCache``, and the clip bounds are fills on it, so a lookup
copies nothing from the host and a CUDA graph may capture it.  Every
``jnp.clip`` of the JAX version whose argument can sit on a bound is written
``torch.minimum(torch.maximum(x, lo), hi)``: that splits the derivative
0.5 / 0.5 at a tie, as ``jnp.clip`` does (``torch.clamp`` passes 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .tacot import (_DeviceCache, _spline_eval_levels, natural_spline_y2,
                    spline_eval)


@dataclass
class ClampStats:
    p: int = 0
    bg: int = 0
    t: int = 0


def _const(c, like):
    """The number ``c`` as a 0-d tensor in ``like``'s dtype on its device,
    by a fill: no copy from the host."""
    return torch.full((), c, dtype=like.dtype, device=like.device)


def _clip(x, lo, hi):
    """``jnp.clip``'s value and derivative rule (0.5 at a tie)."""
    return torch.minimum(torch.maximum(x, _const(lo, x)), _const(hi, x))


def _interval(levels, q):
    """Interval index (lo, hi) of each query on sorted ``levels``: hi =
    searchsorted-left (#{i: levels[i] < q}) clipped to [1, L - 1], from a
    detached copy of the query."""
    hi = torch.clamp(torch.searchsorted(levels, q.detach().contiguous()),
                     1, levels.shape[0] - 1)
    return hi - 1, hi


@dataclass
class BPrimeTable:
    p_levels: np.ndarray       # (Lp,)
    bg_levels: np.ndarray      # (Lbg,) shared across p levels
    T_tab: np.ndarray          # (Lp, Lbg, nTmax) per-level T knots (padded)
    T_hi: np.ndarray           # (Lp, Lbg) true top knot per level
    bc: np.ndarray             # (Lp, Lbg, nTmax)
    hw: np.ndarray             # (Lp, Lbg, nTmax)
    bc2: np.ndarray            # spline second derivatives (0 on padding)
    hw2: np.ndarray
    uniform: bool = True       # every level shares identical T knots
    clamp_stats: ClampStats = field(default_factory=ClampStats)
    _dev: _DeviceCache = field(default_factory=_DeviceCache, repr=False,
                               compare=False)

    @property
    def T(self):
        """Shared T grid for uniform tables; level (0,0)'s knots
        otherwise (ragged tables have no shared grid)."""
        return self.T_tab[0, 0]

    @classmethod
    def load_file(cls, path: str) -> "BPrimeTable":
        """Parse the whitespace PATO format: p bg bc T hw per row, //-comments."""
        rows = []
        with open(path) as f:
            for line in f:
                parts = line.split("//")[0].split()
                if len(parts) < 5:
                    continue
                try:
                    vals = [float(v) for v in parts[:5]]
                except ValueError:
                    continue
                rows.append(vals)
        if not rows:
            raise ValueError(f"B-prime table contains no readable data: {path}")
        arr = np.asarray(rows)  # columns: p, bg, bc, T, hw
        return cls.from_rows(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3],
                             arr[:, 4])

    @classmethod
    def from_rows(cls, p, bg, bc, T, hw) -> "BPrimeTable":
        """Group rows into (p, B'g) levels; every level keeps its own
        sorted T knots (ragged tables: one cubic spline per level over that
        level's rows).  Levels are padded to the longest row with a
        monotone knot extension carrying the end value (y2 = 0); lookups
        clamp the query to each level's true T range, so padded knots are
        never evaluated."""
        p = np.asarray(p); bg = np.asarray(bg)
        bc = np.asarray(bc); T = np.asarray(T); hw = np.asarray(hw)
        ps = np.unique(p)
        bgs = np.unique(bg)
        Lp, Lbg = len(ps), len(bgs)
        levels = {}
        nTmax = 0
        for i, pv in enumerate(ps):
            for j, bgv in enumerate(bgs):
                sel = (p == pv) & (bg == bgv)
                if not sel.any():
                    raise ValueError(
                        "B' table must have every (p, B'g) combination "
                        f"(missing p={pv}, B'g={bgv})")
                Tsel = T[sel]
                order = np.argsort(Tsel)
                Tu, idx = np.unique(Tsel[order], return_index=True)
                if len(Tu) < 2:
                    raise ValueError(
                        f"B' level (p={pv}, B'g={bgv}) needs >= 2 T rows")
                levels[i, j] = (Tu, bc[sel][order][idx],
                                hw[sel][order][idx])
                nTmax = max(nTmax, len(Tu))
        T_tab = np.zeros((Lp, Lbg, nTmax))
        T_hi = np.zeros((Lp, Lbg))
        bc_t = np.zeros((Lp, Lbg, nTmax))
        hw_t = np.zeros((Lp, Lbg, nTmax))
        bc2 = np.zeros((Lp, Lbg, nTmax))
        hw2 = np.zeros((Lp, Lbg, nTmax))
        T00 = levels[0, 0][0]
        uniform = True
        for (i, j), (Tu, bcu, hwu) in levels.items():
            nTl = len(Tu)
            npad = nTmax - nTl
            uniform &= (nTl == len(T00)) and bool(np.allclose(Tu, T00))
            T_hi[i, j] = Tu[-1]
            dpad = Tu[-1] - Tu[-2]
            T_tab[i, j] = np.concatenate(
                [Tu, Tu[-1] + dpad * np.arange(1, npad + 1)])
            bc_t[i, j] = np.concatenate([bcu, np.full(npad, bcu[-1])])
            hw_t[i, j] = np.concatenate([hwu, np.full(npad, hwu[-1])])
            bc2[i, j, :nTl] = natural_spline_y2(Tu, bcu)
            hw2[i, j, :nTl] = natural_spline_y2(Tu, hwu)
        return cls(ps, bgs, T_tab, T_hi, bc_t, hw_t, bc2, hw2,
                   uniform=uniform)

    @classmethod
    def synthetic_tacot(cls) -> "BPrimeTable":
        """A physically-shaped synthetic TACOT-in-air B' table for testing
        when the PATO data deck is unavailable.  B'c ramps smoothly from
        the oxidation plateau (~0.17) to the sublimation regime above
        ~3000 K, decreasing with B'g dilution; h_w grows roughly like
        hot-gas enthalpy.  NOT validation data: shapes only."""
        ps = np.array([1013.25, 10132.5, 101325.0])
        bgs = np.array([1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0])
        Ts = np.linspace(200.0, 4000.0, 96)
        bc = np.zeros((len(ps), len(bgs), len(Ts)))
        hw = np.zeros_like(bc)
        for i, p in enumerate(ps):
            for j, bg in enumerate(bgs):
                T_ox = 1200.0 + 60.0 * np.log10(p / 101325.0 + 1e-12)
                plateau = 0.17 / (1.0 + bg)
                subl_T = 3200.0 + 80.0 * np.log10(p / 1013.25)
                ox = plateau / (1.0 + np.exp(-(Ts - T_ox) / 80.0))
                subl = 2.0 / (1.0 + np.exp(-(Ts - subl_T) / 60.0))
                bc[i, j] = ox + subl
                hw[i, j] = 1.1e3 * (Ts - 298.0) + 0.12 * (Ts - 298.0) ** 2 \
                    - 4.0e5 * bg / (1.0 + bg)
        P, BG, TT = np.meshgrid(ps, bgs, Ts, indexing="ij")
        return cls.from_rows(P.ravel(), BG.ravel(), bc.ravel(),
                             TT.ravel(), hw.ravel())

    # -- lookup ------------------------------------------------------------

    def _eval_levels(self, name, T):
        """Splines of every (p, B'g) level of the table ``name`` ("bc" or
        "hw") at T: (val, dT, clamped), each (Lp, Lbg, *T.shape)."""
        Lp, Lbg, nT = self.T_tab.shape
        dev = lambda key, a: self._dev.get(key, a, T)
        y = dev(name, getattr(self, name))
        y2 = dev(name + "2", getattr(self, name + "2"))
        if self.uniform:
            v, d, c = _spline_eval_levels(dev("T0", self.T_tab[0, 0]),
                                          y.reshape(Lp * Lbg, nT),
                                          y2.reshape(Lp * Lbg, nT), T)
            shape = (Lp, Lbg) + tuple(T.shape)
            return v.reshape(shape), d.reshape(shape), c.reshape(shape)
        T_tab = dev("T_tab", self.T_tab)
        vals, ders, cls_ = [], [], []
        for i in range(Lp):
            for j in range(Lbg):
                lo, hi = self.T_tab[i, j, 0], self.T_hi[i, j]
                v, d, _ = spline_eval(T_tab[i, j], y[i, j], y2[i, j],
                                      _clip(T, lo, hi))
                c = (T < lo) | (T > hi)
                vals.append(v)
                ders.append(torch.where(c, 0.0, d))
                cls_.append(c)
        shape = (Lp, Lbg) + tuple(T.shape)
        return (torch.stack(vals).reshape(shape),
                torch.stack(ders).reshape(shape),
                torch.stack(cls_).reshape(shape))

    def lookup(self, p, bg, T, count_clamps: bool = False):
        """Batched lookup.

        Returns dict(bc, hw, dbc_dbg, dbc_dT, dhw_dbg, dhw_dT, clamped_p,
        clamped_bg, clamped_t, nonsmooth_bg): tensors of the broadcast
        shape of (p, bg, T), in T's dtype and on its device."""
        T = torch.as_tensor(T)
        t = lambda a: torch.as_tensor(a, dtype=T.dtype, device=T.device)
        p, bg, T = torch.broadcast_tensors(t(p), t(bg), T)
        # flat queries: indexing with a 0-d index tensor (a scalar query
        # under vmap) would read it back as a Python integer
        shape = T.shape
        p, bg, T = p.reshape(-1), bg.reshape(-1), T.reshape(-1)
        ps, bgs = self.p_levels, self.bg_levels
        Lp = len(ps)

        bc_v, bc_d, bc_c = self._eval_levels("bc", T)
        hw_v, hw_d, hw_c = self._eval_levels("hw", T)

        # B'g axis: clamp + linear
        bg_min, bg_max = bgs[0], bgs[-1]
        bg_q = _clip(bg, bg_min, bg_max)
        clamped_bg = (bg < bg_min) | (bg > bg_max)
        bgs_t = self._dev.get("bg_levels", bgs, T)
        lj, hj = _interval(bgs_t, bg_q)
        bg0, bg1 = bgs_t[lj], bgs_t[hj]
        wbg = (bg_q - bg0) / (bg1 - bg0)
        tol = 1e-12 * torch.clamp(torch.abs(bg_q.detach()), min=1.0)
        on_node = (torch.abs(bg_q - bg0) <= tol) | \
                  (torch.abs(bg_q - bg1) <= tol)
        nonsmooth_bg = clamped_bg | on_node

        def sel_bg(a, idx):
            # a (Lp, Lbg, *S): level idx (*S) of the B'g axis -> (Lp, *S)
            ix = torch.broadcast_to(idx[None, None], (a.shape[0], 1)
                                    + tuple(idx.shape))
            return torch.gather(a, 1, ix)[:, 0]

        def interp_bg(vals, ders):
            v0, v1 = sel_bg(vals, lj), sel_bg(vals, hj)
            d0, d1 = sel_bg(ders, lj), sel_bg(ders, hj)
            val = (1 - wbg) * v0 + wbg * v1
            dT = (1 - wbg) * d0 + wbg * d1
            dbg = torch.where(clamped_bg, 0.0, (v1 - v0) / (bg1 - bg0))
            return val, dT, dbg

        bc_p, bc_dT_p, bc_dbg_p = interp_bg(bc_v, bc_d)
        hw_p, hw_dT_p, hw_dbg_p = interp_bg(hw_v, hw_d)
        clamped_t = torch.any((bc_c | hw_c).reshape((-1,) + tuple(T.shape)),
                              dim=0)

        # pressure axis: clamp + log-linear
        p_min, p_max = ps[0], ps[-1]
        p_q = _clip(p, p_min, p_max)
        clamped_p = (p < p_min) | (p > p_max)
        if Lp == 1:
            mix = lambda a: a[0]
        else:
            ps_t = self._dev.get("p_levels", ps, T)
            lo, hi = _interval(ps_t, p_q)
            floor = self._dev.get("log_floor", 1e-30, T)
            lp0 = torch.log(torch.maximum(ps_t[lo], floor))
            lp1 = torch.log(torch.maximum(ps_t[hi], floor))
            w = (torch.log(torch.maximum(p_q, floor)) - lp0) / (lp1 - lp0)

            def mix(a):
                a0 = torch.gather(a, 0, lo[None])[0]
                a1 = torch.gather(a, 0, hi[None])[0]
                return (1 - w) * a0 + w * a1

        if count_clamps:
            self.clamp_stats.p += int(clamped_p.sum())
            self.clamp_stats.bg += int(clamped_bg.sum())
            self.clamp_stats.t += int(clamped_t.sum())

        out = {
            "bc": mix(bc_p), "hw": mix(hw_p),
            "dbc_dbg": mix(bc_dbg_p), "dbc_dT": mix(bc_dT_p),
            "dhw_dbg": mix(hw_dbg_p), "dhw_dT": mix(hw_dT_p),
            "clamped_p": clamped_p, "clamped_bg": clamped_bg,
            "clamped_t": clamped_t, "nonsmooth_bg": nonsmooth_bg,
        }
        return {k: v.reshape(shape) for k, v in out.items()}
