"""The port's GMRES before and after its Givens state moved to numpy
scalars, timed on the card (not a test: run it by hand).

    python3 tests/gmres_in_turns.py            # in turns, one system
    python3 tests/gmres_in_turns.py --phase15  # chip_smoke's phase 15

Without arguments: the point-block GMRES(400) at rtol 1e-12 on case 1's
first Newton system (the 5,760-DOF strip of chip_smoke phase 11), with the
earlier GMRES (``torch_gmres_before``) and the present one in turns
(before, after, after, before), on the stencil (DIA) matvec, whose sums
repeat bit for bit, and on the element matvec, whose ``index_add_``
scatter varies x between any two runs on the card; prints the seconds,
the iterations and whether the four x are equal.  ``--phase15``:
chip_smoke's phase 15 (15a, 15b, then 15c) with the earlier GMRES
patched into the block solver and the DOF-partitioned class (one rank, so
its reductions are local), holding 15a's driver steps to host-LU first
steps run here.  Needs a CUDA device.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.dirname(os.path.abspath(__file__))]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import cmfem_tpu_torch.parallel.ablation_dofpart as dofpart  # noqa: E402
import cmfem_tpu_torch.solvers.blocksolve as bs  # noqa: E402
from cmfem_tpu_torch import require_cuda  # noqa: E402
from torch_gmres_before import gmres as gmres_before  # noqa: E402


def in_turns(dev, tmp):
    from cmfem_tpu_torch.profiling import first_newton_system

    new = bs.gmres
    c, blocks, R = first_newton_system(dev, tmp, 0, "turns")
    out = {}
    for label, lat in (("stencil", bs.strip_dof_lattice(
            c.fes.node_positions)), ("element", None)):
        bks = bs.BlockNewtonKrylov(c.fes.element_dofs, c.n, c.ess, c.ess,
                                   dof_lattice=lat, device=dev)
        fac = bks.prepare(blocks)
        runs = []
        for name, fn in (("before", gmres_before), ("after", new),
                         ("after", new), ("before", gmres_before)):
            bs.gmres = fn
            try:
                r, s = C.timed(lambda: bks.solve(fac, -R, rtol=1e-12))
            finally:
                bs.gmres = new
            runs.append((name, s, r.inner_iters, r.x))
        xs = [x for *_, x in runs]
        out[label] = {"runs": [(n, s, it) for n, s, it, _ in runs],
                      "x_equal": [torch.equal(xs[0], x) for x in xs]}
    return out


def phase15_before(dev, tmp):
    from cmfem_tpu_torch.apps import ablation_case1, ablation_case2_2
    from cmfem_tpu_torch.core import make_strip_mesh_2d, write_gmsh

    base = {"material_file": C.TACOT_DECK, "order": 1, "dt": 0.1,
            "t_final": 0.1, "bdr_attr_top": 3, "probe_x": 0.00125,
            "newton_print_level": 0, "save_paraview": False,
            "output_every": 1}
    strip = write_gmsh(make_strip_mesh_2d(11, 239),
                       os.path.join(tmp, "lu.msh"))
    tri = write_gmsh(make_strip_mesh_2d(11, 239, geom="triangle"),
                     os.path.join(tmp, "lu_tri.msh"))
    r1 = ablation_case1.run({**base, "mesh_file": strip,
                             "output_path": os.path.join(tmp, "lu1")},
                            device=dev)
    r2 = ablation_case2_2.run(
        {**base, "mesh_file": tri, "bdr_attr_bottom": 1,
         "boundary_conditions_file": C.SCHEDULE_C21,
         "output_path": os.path.join(tmp, "lu22")}, device=dev)
    firsts = (C.first_step_rows(os.path.join(tmp, "lu1"), r1),
              C.first_step_rows(os.path.join(tmp, "lu22"), r2))
    saved = bs.gmres, dofpart.gmres
    bs.gmres = gmres_before
    # one rank: the sum over the ranks is the local value, so the earlier
    # GMRES, which has no reduce hook, takes the hooked one's place
    dofpart.gmres = lambda *a, reduce=None, **k: gmres_before(*a, **k)
    try:
        out, secs = C.timed(lambda: C.run_distributed_ablation(
            dev, tmp, *firsts))
        out["15a_15b_s"] = secs
        out["15c"] = C.run_ablation_gloo_on_card(dev, tmp)
    finally:
        bs.gmres, dofpart.gmres = saved
    return out


if __name__ == "__main__":
    dev = require_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        if "--phase15" in sys.argv[1:]:
            print(json.dumps({"phase15_gmres_before":
                              phase15_before(dev, tmp)}))
        else:
            print(json.dumps({"gmres_in_turns": in_turns(dev, tmp)}))
