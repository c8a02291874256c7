"""Time-tabulated aerothermal boundary environment and top-T schedules.

Port of ``cmfem_tpu/physics/surface_bc.py`` (the reference's
``SurfaceBCSchedule``): 5- or 7-column `.dat` parsing (t, p_w,
rho_e u_e C_H, h_r, [hconv, T_edge], chemistryOn), piecewise-linear
interpolation of the continuous columns and piecewise-LEFT-constant
interpolation of the chemistry toggle; and ``TopTemperatureSchedule``.

Numpy only.  A ``BoundaryState`` holds Python floats and a static
``chemistryOn``: the residuals and their Jacobian transforms take it from
their closure, so it is no pytree here.  Inside the face Jacobians its
boundary values are 0-d device tensors (``physics/seb.py``), the inputs
of their CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BoundaryState:
    p_w: float
    rhoeUeCH: float
    h_r: float
    hconv: float = 0.0
    Tedge: float = 300.0
    has_hconv: bool = False
    has_Tedge: bool = False
    chemistryOn: int = 1


class SurfaceBCSchedule:
    def __init__(self, rows: np.ndarray, has_hconv: bool):
        """rows: (n, 7) [t, p_w, rhoeUeCH, h_r, hconv, Tedge, chem], with
        hconv/Tedge 0/300 when the file has 5 columns."""
        self.rows = rows
        self.has_hconv = has_hconv

    @classmethod
    def load_file(cls, path: str) -> "SurfaceBCSchedule":
        rows = []
        ncols = 0
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                parts = line.split("//")[0].split()
                if not parts:
                    continue
                try:
                    vals = [float(v) for v in parts]
                except ValueError:
                    raise ValueError(
                        f"Invalid numeric value in surface BC schedule at "
                        f"line {ln}: {path}")
                if len(vals) not in (5, 7):
                    raise ValueError(
                        f"Surface BC schedule line {ln} must have 5 or 7 "
                        f"numeric columns: {path}")
                if ncols == 0:
                    ncols = len(vals)
                elif len(vals) != ncols:
                    raise ValueError(
                        f"Inconsistent surface BC schedule column count at "
                        f"line {ln}: {path}")
                if len(vals) == 5:
                    t, p_w, rh, hr, chem = vals
                    hc, te = 0.0, 300.0
                else:
                    t, p_w, rh, hr, hc, te, chem = vals
                rows.append([t, p_w, rh, hr, hc, te,
                             1.0 if chem >= 0.5 else 0.0])
        if not rows:
            raise ValueError(f"Surface BC schedule has no valid rows: {path}")
        arr = np.asarray(sorted(rows, key=lambda r: r[0]))
        return cls(arr, has_hconv=(ncols == 7))

    def eval(self, t: float) -> BoundaryState:
        r = self.rows
        ts = r[:, 0]
        if t <= ts[0]:
            return self._state(r[0], r[0])
        if t >= ts[-1]:
            return self._state(r[-1], r[-1])
        # hi = the FIRST row with t_hi >= t, so at an exact node the
        # left-constant chemistry toggle takes the PRE-node row
        # (side="right" would flip the flux branch one step early)
        hi = int(np.searchsorted(ts, t, side="left"))
        hi = min(max(hi, 1), len(ts) - 1)
        a, b = r[hi - 1], r[hi]
        dt = b[0] - a[0]
        w = (t - a[0]) / dt if dt > 1e-14 else 0.0
        return self._state((1 - w) * a + w * b, a)

    def _state(self, mix, left) -> BoundaryState:
        return BoundaryState(
            p_w=float(mix[1]), rhoeUeCH=float(mix[2]), h_r=float(mix[3]),
            hconv=float(mix[4]) if self.has_hconv else 0.0,
            Tedge=float(mix[5]) if self.has_hconv else 300.0,
            has_hconv=self.has_hconv, has_Tedge=self.has_hconv,
            chemistryOn=int(left[6]),  # piecewise-left-constant
        )


class TopTemperatureSchedule:
    """(time, temperature) table with piecewise-linear ``eval``."""

    def __init__(self, times, values):
        self.times = np.asarray(times)
        self.values = np.asarray(values)
        if len(self.times) == 0:
            raise ValueError("Top temperature schedule is empty")

    @classmethod
    def load_file(cls, path: str) -> "TopTemperatureSchedule":
        ts, vs = [], []
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                parts = line.split("//")[0].split()
                if len(parts) < 2:
                    continue
                try:
                    t, v = float(parts[0]), float(parts[1])
                except ValueError as e:
                    raise ValueError(
                        f"Unparseable top temperature schedule row at line "
                        f"{ln}: {path}") from e
                if t < 0:
                    raise ValueError(
                        f"Negative time in top temperature schedule at line "
                        f"{ln}: {path}")
                if ts and t < ts[-1]:
                    raise ValueError(
                        f"Top temperature schedule times must be nondecreasing "
                        f"at line {ln}: {path}")
                ts.append(t)
                vs.append(v)
        if not ts:
            raise ValueError(f"Top temperature schedule is empty: {path}")
        return cls(ts, vs)

    def eval(self, t: float) -> float:
        return float(np.interp(t, self.times, self.values))
