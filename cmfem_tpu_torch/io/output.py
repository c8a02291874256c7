"""Which process of a distributed run writes the output files.

The ablation drivers run the same host loop on every rank of a world
(``sharding_devices`` / ``dof_partition``), as the reference's drivers run
under ``mpirun``; only rank 0 writes CSV, VTU and restart files.  The
writers ask ``writes_files()``; a driver's rank loop runs inside
``file_output(rank == 0)``.  A process outside any such block writes.
"""

from __future__ import annotations

import contextlib

_state = {"writes": True}


def writes_files() -> bool:
    """Does this process write the output files?"""
    return _state["writes"]


@contextlib.contextmanager
def file_output(enabled: bool):
    """Within the block this process writes output files only if
    ``enabled``."""
    before = _state["writes"]
    _state["writes"] = bool(enabled)
    try:
        yield
    finally:
        _state["writes"] = before
