"""Shared pieces of the code-to-code validation harnesses.

Copy of ``cmfem_tpu/validation/common.py``.  The drivers emit probe/mass/boundary CSVs; these harnesses compare them
against FIAT (case 1) and Amaryllis (cases 2.1/2.2) reference histories
with tolerances stored in the driver input YAML `acceptance:` block
(SURVEY.md §4.2).  Outputs are machine-readable PASS bits per signal plus
an overall PASS row, and comparison PNGs.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def rmse(a, b):
    d = np.asarray(a) - np.asarray(b)
    return float(np.sqrt(np.mean(d * d)))


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def segmented_rmse_max(t, a, b, t0, t1, valid_mask=None):
    """RMSE/max-abs restricted to a time window (compare_ablation_case2_2.py
    segmented_rmse_max)."""
    mask = (t >= t0) & (t <= t1)
    if valid_mask is not None:
        mask = mask & valid_mask
    if not np.any(mask):
        return float("nan"), float("nan")
    return rmse(a[mask], b[mask]), max_abs(a[mask], b[mask])


def _safe_load_yaml(path):
    """yaml.safe_load with an empty-dict fallback for missing/invalid
    files (the harnesses must tolerate absent inputs, §4.2)."""
    import yaml

    path = Path(path)
    if not path.exists():
        return {}
    try:
        data = yaml.safe_load(path.read_text())
    except yaml.YAMLError:
        return {}
    return data if isinstance(data, dict) else {}


def load_acceptance_from_yaml(path, defaults):
    """Acceptance tolerances from the driver input YAML's `acceptance:`
    block, overlaid on the harness defaults (SURVEY.md §4.2)."""
    vals = dict(defaults)
    block = _safe_load_yaml(path).get("acceptance")
    if isinstance(block, dict):
        for k, v in block.items():
            try:
                vals[str(k)] = float(v)
            except (TypeError, ValueError):
                pass
    return vals


def load_probe_depths_from_yaml(path):
    """Probe depths measured from the hot surface (first probe_y entry)."""
    raw = _safe_load_yaml(path).get("probe_y")
    if not isinstance(raw, (list, tuple)):
        return []
    probe_y = []
    for v in raw:
        try:
            probe_y.append(float(v))
        except (TypeError, ValueError):
            pass
    if not probe_y:
        return []
    y_wall = probe_y[0]
    return [abs(y_wall - y) for y in probe_y]


def temperature_by_depth_from_probes(probes, probe_depths):
    """[(depth, name, signal)] sorted by depth, from a driver probes CSV
    (wall at depth 0, TC<i> at probe_depths[i])."""
    items = []
    for name in probes.dtype.names:
        if name == "time":
            continue
        if name == "wall":
            depth = 0.0
        elif name.startswith("TC") and name[2:].isdigit():
            idx = int(name[2:])
            depth = probe_depths[idx] if idx < len(probe_depths) else float(idx)
        else:
            continue
        items.append((depth, name, probes[name]))
    items.sort(key=lambda x: x[0])
    return items


def temperature_by_depth_from_reference(ref_T, probe_depths):
    """Same layout from a reference table (col 0 = time, col i+1 = signal)."""
    items = []
    for i in range(ref_T.shape[1] - 1):
        name = "wall" if i == 0 else f"TC{i}"
        depth = probe_depths[i] if i < len(probe_depths) else float(i)
        items.append((depth, name, ref_T[:, i + 1]))
    items.sort(key=lambda x: x[0])
    return items


def load_pato_point_plot(path):
    """PATO sampled point-plot: header names probes as probeN(x,y,z); rows
    are time + one column per probe; `/`-prefixed comment lines
    (load_pato_point_plot, compare_ablation_case2_2.py:183-200).
    Returns (time (nt,), values (nt, nprobe), probe_y list)."""
    import re

    with open(path) as f:
        header = f.readline().strip()
    y_vals = [float(m.group(1))
              for m in re.finditer(r"probe\d+\([^,]+,([^,]+),", header)]
    data = ensure_2d(np.loadtxt(path, comments=("/", "#")))
    if data.shape[1] < 2:
        raise RuntimeError(f"Unexpected PATO point-plot format in {path}")
    time = data[:, 0]
    vals = data[:, 1:]
    if y_vals and len(y_vals) != vals.shape[1]:
        raise RuntimeError(
            f"PATO point-plot header/data column mismatch in {path}")
    return time, vals, y_vals


def match_probes_by_y(names, series_by_name, probe_y, pato_y, tol=1e-8):
    """Match driver probe columns (by their YAML y-coordinates) to PATO
    point-plot columns by nearest y within tol.  Returns a list of
    (y_pato, driver_name, pato_col, driver_series), surface-down."""
    # index-pair matching with consumption: a float-keyed dict would drop
    # duplicate-y probes and let one driver probe match several PATO
    # columns
    avail = [(probe_y[i], nm) for i, nm in enumerate(names)
             if i < len(probe_y)]
    matched = []
    for j, yp in enumerate(pato_y):
        if not avail:
            break
        k = min(range(len(avail)), key=lambda i: abs(avail[i][0] - yp))
        if abs(avail[k][0] - yp) <= tol:
            _, nm = avail.pop(k)
            matched.append((yp, nm, j, series_by_name[nm]))
    matched.sort(key=lambda x: x[0], reverse=True)
    return matched


def write_metrics_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["category", "signal", "rmse", "max_abs", "metric",
                    "value", "tolerance", "pass"])
        for r in rows:
            w.writerow(r)


def ensure_2d(a):
    a = np.asarray(a)
    return a[None, :] if a.ndim == 1 else a
