"""Shared by the ``tests/test_torch_scripts_*.py`` files: the JAX
package's study scripts (``scripts/*.py``, which are no package), loaded
from their files, and the refinement study's parity checks (one level per
test file: each level compiles its own JAX programs, ~80 s)."""

import importlib.util
import itertools
import os

import jax.numpy as jnp
import numpy as np

from torch_ablation_helpers import FIXTURE, TOP

DT = 0.0025
RTOL = 1e-6

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """``scripts/<name>.py`` as a module (its top level only sets paths and
    constants; nothing there runs a study)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _jax_system(jsys, jops, ess, state, model, bprime):
    """The JAX study's residual, element and face blocks of one state
    (``scripts/blocksolve_refinement.py``'s loop body)."""
    from cmfem_tpu.physics.seb import classify_branch
    from cmfem_tpu.physics.surface_bc import BoundaryState

    _, T_np, p_np, X_np, verts, chem = state
    n = jsys.n
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess + n] = True
    T, p = jnp.asarray(T_np), jnp.asarray(p_np)
    X = jnp.asarray(np.broadcast_to(
        X_np.reshape(jsys.ne, jsys.nq, -1),
        (jsys.ne, jsys.nq, jsys.mat.num_reactions)).copy())
    v = jnp.asarray(verts)
    gf = jops.geometric_factors(v)
    bc = BoundaryState(p_w=101325.0, rhoeUeCH=0.3 if chem else 0.003,
                       h_r=1.5e6 if chem else 0.0, hconv=0.0, Tedge=300.0,
                       has_hconv=False, has_Tedge=False, chemistryOn=chem)
    branch = classify_branch(bc, model)
    To, po = jops.values_at_qp(T), jops.values_at_qp(p)
    RT, Rp = jsys.residual(T, p, To, po, X, DT, gf=gf)
    RT = RT + jsys.seb_face_residual(T, p, X, bc, branch, model, bprime,
                                     vertices=v)
    R = jnp.where(jnp.asarray(mask2), 0.0, jnp.concatenate([RT, Rp]))
    blocks = jsys.element_jacobians(T, p, To, po, X, DT, gf=gf)
    face = jsys.seb_face_jacobians(T, p, X, bc, branch, model, bprime,
                                   vertices=v)
    return branch, R, blocks, face


def refinement_parity(strip, lvl):
    """The parity checks of the refinement study at refinement ``lvl`` of
    the strip file ``strip`` (``test_torch_scripts_refinement*.py``)."""
    from cmfem_tpu.core import FESpace, load_gmsh as jload
    from cmfem_tpu.ops import SpaceOps
    from cmfem_tpu.physics.ablation import AblationSystem
    from cmfem_tpu.physics.bprime import BPrimeTable
    from cmfem_tpu.physics.seb import SurfaceFluxModel
    from cmfem_tpu.physics.tacot import TacotMaterial
    from cmfem_tpu.solvers import BlockNewtonKrylov
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice

    from cmfem_tpu_torch.core import load_gmsh
    from cmfem_tpu_torch.physics.bprime import BPrimeTable as PBPrime
    from cmfem_tpu_torch.physics.seb import SurfaceFluxModel as PModel

    from cmfem_tpu_torch.scripts import blocksolve_refinement as P

    J = jax_script("blocksolve_refinement")
    # the port's study
    mesh = load_gmsh(strip).uniform_refine(lvl) if lvl else load_gmsh(strip)
    fes, psys, ess, lat = P.level(mesh, "cpu")
    n = fes.nscalar
    pstates = P.make_states(fes, psys, psys.mat, n, mesh.vertices)
    solvers = P.solvers_of(fes, ess, lat, lvl, 400, 10, 1, "cpu")
    assert set(solvers) == {"linemg", "pointblock"}
    # the JAX study's, on the same mesh file
    jmesh = jload(strip).uniform_refine(lvl) if lvl else jload(strip)
    jfes = FESpace(jmesh, 1)
    jops = SpaceOps(jfes, quad_order=4)
    jsys = AblationSystem(jops, TacotMaterial.load_yaml(FIXTURE),
                          top_attr=TOP)
    jess = np.asarray(jfes.boundary_dofs([TOP]))
    assert np.array_equal(jess, ess)
    jlat = strip_dof_lattice(jfes.node_positions)
    jstates = J.make_states(jfes, jsys, jsys.mat, n, jmesh.vertices)
    for ps, js in zip(pstates, jstates):
        assert ps[0] == js[0] and ps[5] == js[5]
        for a, b in zip(ps[1:5], js[1:5]):
            assert _rel(a, b) <= 1e-12, ps[0]
    jsolvers = {
        "linemg": BlockNewtonKrylov(
            np.asarray(jfes.element_dofs), n, np.zeros(0, np.int64), jess,
            restart=60, maxiter=5, dof_lattice=jlat, pc="linemg"),
        "pointblock": BlockNewtonKrylov(
            np.asarray(jfes.element_dofs), n, np.zeros(0, np.int64), jess,
            restart=400, maxiter=10, dof_lattice=jlat)}
    model, pmodel = SurfaceFluxModel(case22=True), PModel(case22=True)
    jbp, pbp = BPrimeTable.synthetic_tacot(), PBPrime.synthetic_tacot()
    for ps, js in zip(pstates, jstates):
        branch, R, blocks, face = P.state_system(psys, ess, ps, DT, pmodel,
                                                 pbp)
        jbranch, jR, jblocks, jface = _jax_system(jsys, jops, jess, js,
                                                  model, jbp)
        assert branch == jbranch
        assert _rel(R.numpy(), jR) <= 1e-9, ps[0]
        for a, b in zip((*blocks, *face), (*jblocks, *jface)):
            assert _rel(a.numpy(), b) <= 1e-12, ps[0]
        for (pc, bks), rtol in itertools.product(solvers.items(),
                                                 (RTOL, 1e-10)):
            jb = jsolvers[pc]
            res = bks.solve(bks.prepare(blocks, face=face,
                                        face_elem=psys.trace.elem),
                            -R, rtol=rtol)
            jres = jb.solve(jb.prepare(jblocks, face=jface,
                                       face_elem=jsys.trace.elem),
                            -jR, rtol=rtol)
            what = (lvl, ps[0], pc, rtol)
            assert res.converged and bool(jres.converged), what
            assert res.iters == int(jres.iters), what
            assert res.inner_iters == int(jres.inner_iters), what
            if pc == "linemg" or rtol < RTOL:
                x, jx = res.x.numpy(), np.asarray(jres.x)
                assert np.linalg.norm(x - jx) <= 1e-8 * np.linalg.norm(jx), \
                    what
