"""ctypes bindings for the native runtime kernels (native/cmfem_native.cpp).

A copy of ``cmfem_tpu/native/__init__.py`` (ctypes and numpy only), bound to
the same ``native/libcmfem_native.so`` at the repository root.  The native
library provides the runtime pieces the reference implements in
C++ (Gmsh IO, DOF topology, partitioning); the Python callers have numpy
implementations of the same functions, which run when the library is absent
or does not load.  ``load_native`` says so once, with a warning, and builds
nothing: the library is made beforehand with

    make -C native
"""

from __future__ import annotations

import ctypes
import os
import warnings

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcmfem_native.so")


def load_native():
    """Return the loaded library, or None (with one warning that names the
    reason) where it is absent or does not load."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    if _TRIED:
        return None
    _TRIED = True
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        warnings.warn(f"native library not loaded ({e}): the GMSH reader, "
                      f"the edge enumeration and the point locator run "
                      f"their numpy versions", RuntimeWarning, stacklevel=2)
        return None

    lib.gmsh_open.restype = ctypes.c_void_p
    lib.gmsh_open.argtypes = [ctypes.c_char_p] + \
        [ctypes.POINTER(ctypes.c_int)] * 6
    lib.gmsh_read.restype = None
    lib.gmsh_read.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.gmsh_close.restype = None
    lib.gmsh_close.argtypes = [ctypes.c_void_p]
    lib.enumerate_edges.restype = ctypes.c_int64
    lib.enumerate_edges.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.rcb_partition.restype = None
    lib.rcb_partition.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    _LIB = lib
    return _LIB


def gmsh_parse_native(path: str):
    """Parse a GMSH v2.2 file with the native parser.

    Returns (dim, xyz (n,3), elem (ne,nc), elem_attr, bdr (nb,ncb),
    bdr_attr) or None if the library is unavailable/parse failed."""
    lib = load_native()
    if lib is None:
        return None
    dim = ctypes.c_int()
    nn = ctypes.c_int()
    ne = ctypes.c_int()
    nc = ctypes.c_int()
    nb = ctypes.c_int()
    ncb = ctypes.c_int()
    h = lib.gmsh_open(path.encode(), ctypes.byref(dim), ctypes.byref(nn),
                      ctypes.byref(ne), ctypes.byref(nc), ctypes.byref(nb),
                      ctypes.byref(ncb))
    if not h:
        return None
    try:
        xyz = np.empty((nn.value, 3))
        elem = np.empty((ne.value, nc.value), dtype=np.int32)
        elem_attr = np.empty(ne.value, dtype=np.int32)
        bdr = np.empty((nb.value, max(ncb.value, 1)), dtype=np.int32)
        bdr_attr = np.empty(nb.value, dtype=np.int32)
        lib.gmsh_read(h, xyz.ctypes.data, elem.ctypes.data,
                      elem_attr.ctypes.data, bdr.ctypes.data,
                      bdr_attr.ctypes.data)
    finally:
        lib.gmsh_close(h)
    return dim.value, xyz, elem, elem_attr, bdr, bdr_attr


def enumerate_edges_native(conn: np.ndarray, edge_pairs):
    """Native unique-edge enumeration; returns (edge_ids, edge_dirs,
    n_edges) or None."""
    lib = load_native()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    ep = np.ascontiguousarray(np.asarray(edge_pairs, dtype=np.int32))
    ne, nverts = conn.shape
    nle = len(edge_pairs)
    edge_ids = np.empty((ne, nle), dtype=np.int64)
    edge_dirs = np.empty((ne, nle), dtype=np.int32)
    n = lib.enumerate_edges(conn.ctypes.data, ne, nverts, ep.ctypes.data,
                            nle, edge_ids.ctypes.data, edge_dirs.ctypes.data)
    return edge_ids, edge_dirs, int(n)


def rcb_partition_native(centroids: np.ndarray, nparts: int):
    """Native recursive-coordinate-bisection partition; returns part ids
    (n,) int32 or None."""
    lib = load_native()
    if lib is None:
        return None
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    n, dim = c.shape
    parts = np.empty(n, dtype=np.int32)
    lib.rcb_partition(c.ctypes.data, n, dim, nparts, parts.ctypes.data)
    return parts


class NativeLocator:
    """Bucket-grid candidate generator for point location (the
    ParMesh::FindPoints candidate stage).  Build once per mesh
    configuration; ``query`` returns bbox-filtered (point, element)
    candidate pairs for the batched inverse-map sweep."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    @classmethod
    def build(cls, vertices: np.ndarray, conn: np.ndarray, tol: float):
        lib = load_native()
        if lib is None:
            return None
        if not hasattr(lib, "_locator_bound"):
            lib.locator_build.restype = ctypes.c_void_p
            lib.locator_build.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_double,
            ]
            lib.locator_query.restype = ctypes.c_int64
            lib.locator_query.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.locator_free.restype = None
            lib.locator_free.argtypes = [ctypes.c_void_p]
            lib._locator_bound = True
        v = np.ascontiguousarray(vertices, dtype=np.float64)
        c = np.ascontiguousarray(conn, dtype=np.int32)
        nv, dim = v.shape
        ne, nc = c.shape
        h = lib.locator_build(v.ctypes.data, nv, dim, c.ctypes.data, ne, nc,
                              float(tol))
        if not h:
            return None
        return cls(lib, h)

    def query(self, points: np.ndarray):
        """(pair_pts, pair_elems) int64 candidate arrays."""
        p = np.ascontiguousarray(points, dtype=np.float64)
        npts = len(p)
        cap = max(64, npts * 8)
        while True:
            pp = np.empty(cap, dtype=np.int64)
            pe = np.empty(cap, dtype=np.int64)
            n = self._lib.locator_query(self._h, p.ctypes.data, npts, cap,
                                        pp.ctypes.data, pe.ctypes.data)
            if n <= cap:
                return pp[:n], pe[:n]
            cap = int(n)

    def __del__(self):
        try:
            self._lib.locator_free(self._h)
        except Exception:
            pass
