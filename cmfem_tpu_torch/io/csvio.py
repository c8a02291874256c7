"""CSV output streams with flush-per-row semantics.

Copy of ``cmfem_tpu/io/csvio.py``: the reference drivers' CSV logging
(headers + setprecision(16) + flush each step)."""

from __future__ import annotations

import os

from .output import writes_files


class CsvWriter:
    """A CSV stream; on a rank that writes no files (``io.output``) the
    rows go to ``os.devnull``."""

    def __init__(self, path, header: list[str], precision: int = 16):
        self.path = path
        self.precision = precision
        if writes_files():
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self.f = open(path, "w")
        else:
            self.f = open(os.devnull, "w")
        self.f.write(",".join(header) + "\n")
        self.f.flush()

    def writerow(self, values):
        out = []
        for v in values:
            if isinstance(v, float):
                out.append(f"{v:.{self.precision}g}")
            else:
                out.append(str(v))
        self.f.write(",".join(out) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
