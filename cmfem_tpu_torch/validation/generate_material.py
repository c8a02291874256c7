"""Generate a self-contained TACOT material YAML from a PATO data deck.

Copy of ``cmfem_tpu/validation/generate_material.py``.

Port of generate_material_tacot_case1.py: regex-parses PATO
``constantProperties`` (OpenFOAM dictionary style) plus the
virgin/char/gasProperties whitespace tables into the material YAML schema
consumed by TacotMaterial.load_yaml.
"""

from __future__ import annotations

import argparse
import math
import re
from pathlib import Path

FLOAT_RE = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def parse_numeric_rows(path: Path, min_cols: int):
    rows = []
    for raw in path.read_text().splitlines():
        line = raw.split("//", 1)[0].strip()
        if not line:
            continue
        try:
            vals = [float(t) for t in line.split()]
        except ValueError:
            continue
        if len(vals) >= min_cols:
            rows.append(vals)
    return rows


def parse_constant_properties(path: Path):
    text = path.read_text().splitlines()
    out = {}
    scalars = {
        "R": rf"^\s*R\s+R\s+\[[^\]]*\]\s+({FLOAT_RE})\s*;",
        "K_v": rf"^\s*K_v\s+K_v\s+\[[^\]]*\]\s+\(({FLOAT_RE})",
        "K_c": rf"^\s*K_c\s+K_c\s+\[[^\]]*\]\s+\(({FLOAT_RE})",
        "eps_g_v": rf"^\s*eps_g_v\s+eps_g_v\s+\[[^\]]*\]\s+({FLOAT_RE})\s*;",
        "eps_g_c": rf"^\s*eps_g_c\s+eps_g_c\s+\[[^\]]*\]\s+({FLOAT_RE})\s*;",
        "rhoI1": rf"^\s*rhoI\[1\]\s+rhoI\[1\]\s+\[[^\]]*\]\s+({FLOAT_RE})\s*;",
        "rhoI2": rf"^\s*rhoI\[2\]\s+rhoI\[2\]\s+\[[^\]]*\]\s+({FLOAT_RE})\s*;",
        "epsI1": rf"^\s*epsI\[1\]\s+epsI\[1\]\s+\[[^\]]*\]\s+({FLOAT_RE})\s*;",
        "epsI2": rf"^\s*epsI\[2\]\s+epsI\[2\]\s+\[[^\]]*\]\s+({FLOAT_RE})\s*;",
    }
    for key, pat in scalars.items():
        rx = re.compile(pat)
        for ln in text:
            m = rx.match(ln)
            if m:
                out[key] = float(m.group(1))
                break
        if key not in out:
            raise RuntimeError(f"Failed to parse {key} from {path}")

    reactions = {}
    rkeys = ["F", "A", "E", "m", "n", "T", "h"]
    for ln in text:
        line = ln.split("//", 1)[0].strip()
        for rk in rkeys:
            m = re.match(rf"^{rk}\[2\]\[(\d+)\].*?({FLOAT_RE})\s*;", line)
            if m:
                reactions.setdefault(int(m.group(1)), {})[rk] = \
                    float(m.group(2))
    if not reactions:
        raise RuntimeError(f"No reactions parsed from {path}")
    ordered = []
    for idx in sorted(reactions):
        r = reactions[idx]
        missing = [k for k in rkeys if k not in r]
        if missing:
            raise RuntimeError(f"Reaction {idx} missing keys {missing}")
        ordered.append({"F": r["F"], "A": r["A"], "E": r["E"], "m": r["m"],
                        "n": r["n"], "T_threshold": r["T"], "h": r["h"]})
    out["reactions"] = ordered
    return out


def group_by_pressure(rows, keep_cols):
    grouped = {}
    for row in rows:
        grouped.setdefault(row[0], []).append([row[i] for i in keep_cols])
    return [(p, sorted(grouped[p], key=lambda r: r[0]))
            for p in sorted(grouped)]


def _fmt(x):
    if math.isnan(x) or math.isinf(x):
        raise ValueError("Non-finite value encountered in material data")
    return f"{x:.12g}"


def write_material_yaml(out_path: Path, source_dir, constants, virgin, char,
                        gas, name="TACOT"):
    L = [f"material_name: {name}", "source:", f"  path: {source_dir}",
         "constants:", f"  R: {_fmt(constants['R'])}", "phases:",
         f"  rhoI: [{_fmt(constants['rhoI1'])}, {_fmt(constants['rhoI2'])}]",
         f"  epsI: [{_fmt(constants['epsI1'])}, {_fmt(constants['epsI2'])}]",
         "transport:",
         f"  K_v: {_fmt(constants['K_v'])}",
         f"  K_c: {_fmt(constants['K_c'])}",
         f"  eps_g_v: {_fmt(constants['eps_g_v'])}",
         f"  eps_g_c: {_fmt(constants['eps_g_c'])}",
         "reactions:"]
    for i, r in enumerate(constants["reactions"], 1):
        L.append(f"  - id: r{i}")
        for k in ("F", "A", "E", "m", "n", "T_threshold", "h"):
            L.append(f"    {k}: {_fmt(r[k])}")
    L.append("tables:")
    for tname, grouped, cols in (("virgin", virgin, "[T, cp, h, k]"),
                                 ("char", char, "[T, cp, h, k]"),
                                 ("gas", gas, "[T, M, h, mu]")):
        L.append(f"  {tname}:")
        L.append(f"    columns: {cols}")
        L.append("    pressure_tables:")
        for p, rows in grouped:
            L.append(f"      - p: {_fmt(p)}")
            L.append("        rows:")
            for r in rows:
                L.append(f"          - [{', '.join(_fmt(v) for v in r)}]")
    out_path.write_text("\n".join(L) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source-dir", required=True,
                    help="PATO TACOT folder (constantProperties, virgin, "
                         "char, gasProperties)")
    ap.add_argument("--out", default="material_tacot.yaml")
    ap.add_argument("--name", default="TACOT")
    args = ap.parse_args(argv)

    src = Path(args.source_dir).expanduser().resolve()
    constants = parse_constant_properties(src / "constantProperties")
    virgin = group_by_pressure(parse_numeric_rows(src / "virgin", 7),
                               (1, 2, 3, 4))
    char = group_by_pressure(parse_numeric_rows(src / "char", 7), (1, 2, 3, 4))
    gas = group_by_pressure(parse_numeric_rows(src / "gasProperties", 5),
                            (1, 2, 3, 4))
    out = Path(args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    write_material_yaml(out, src, constants, virgin, char, gas, args.name)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
