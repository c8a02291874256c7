"""Element partitioning for distributed runs.

Copy of ``cmfem_tpu/parallel/partition.py`` (numpy; the JAX package's
module cannot be imported without JAX).  Recursive coordinate bisection
(RCB) over element centroids assigns elements to ranks with spatial
locality, so the shared-DOF exchange stays a surface term.  The native C++
RCB (``native.rcb_partition_native``, the same ``libcmfem_native.so`` both
packages load) runs when it is built, the numpy version otherwise; both
give the same parts.
"""

from __future__ import annotations

import numpy as np

from ..core.mesh import Mesh


def _rcb_numpy(centroids: np.ndarray, nparts: int) -> np.ndarray:
    parts = np.zeros(len(centroids), dtype=np.int32)

    def recurse(idx, lo_part, hi_part):
        if hi_part - lo_part <= 1 or len(idx) == 0:
            # more parts than elements leaves empty subsets: they take
            # lo_part (an empty slice) and the trailing parts stay empty
            parts[idx] = lo_part
            return
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        n = hi_part - lo_part
        left = n // 2
        k = len(idx) * left // n
        order = np.argsort(c[:, axis], kind="stable")
        recurse(idx[order[:k]], lo_part, lo_part + left)
        recurse(idx[order[k:]], lo_part + left, hi_part)

    recurse(np.arange(len(centroids)), 0, nparts)
    return parts


def partition_elements(mesh: Mesh, nparts: int, method: str = "rcb",
                       vertices=None) -> np.ndarray:
    """(ne,) int32 part assignment for each element."""
    if nparts <= 1:
        return np.zeros(mesh.num_elements, dtype=np.int32)
    if method == "contiguous":
        return (np.arange(mesh.num_elements) * nparts
                // mesh.num_elements).astype(np.int32)
    if method != "rcb":
        raise ValueError(f"Unknown partition method: {method}")
    verts = np.asarray(mesh.vertices if vertices is None else vertices)
    centroids = verts[mesh.elem_conn].mean(axis=1)
    from ..native import rcb_partition_native

    parts = rcb_partition_native(centroids, nparts)
    if parts is not None:
        return parts
    return _rcb_numpy(centroids, nparts)


def partition_permutation(parts: np.ndarray, nparts: int | None = None):
    """Stable permutation grouping elements by part; returns (perm, counts)
    so that elements perm[offset_k : offset_k + counts[k]] belong to part
    k.  ``nparts`` sizes counts explicitly so trailing empty parts keep
    their (zero) slots; default parts.max() + 1."""
    parts = np.asarray(parts)
    if nparts is None:
        nparts = int(parts.max()) + 1 if len(parts) else 1
    order = np.argsort(parts, kind="stable")
    counts = np.bincount(parts, minlength=nparts)
    return order, counts
