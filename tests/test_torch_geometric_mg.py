"""Port parity: ``core/pointlocate.py``, ``native.py`` and ``GeometricMG``.

- ``locate_points`` and ``h1_sampling_stencil`` give the JAX package's arrays
  exactly (they are numpy copies) on refined quad and triangle hierarchies;
- a V-cycle with the JAX hierarchy's level state carried across by
  ``interop.geometric_mg_from_arrays`` (the two packages' power iterations
  start from different random vectors, so ``lmax`` must be carried) agrees to
  1e-10 of max|z|, and PCG and GMRES preconditioned with it take the same
  number of iterations;
- the port's own ``build`` estimates ``lmax`` within 15% of JAX's, and its
  PCG converges in as many iterations, give or take one;
- ``make_mg_preconditioner`` builds the same hierarchy from a ``cfg``."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cmfem_tpu.core import FESpace as JFESpace, load_gmsh as j_load_gmsh
from cmfem_tpu.core import make_cartesian_mesh_2d as j_mesh2d
from cmfem_tpu.core import pointlocate as jloc
from cmfem_tpu.ops import BilinearForm as JForm
from cmfem_tpu.solvers import GeometricMG as JGeometricMG
from cmfem_tpu.solvers import cg as jcg, gmres as jgmres

from cmfem_tpu_torch import native
from cmfem_tpu_torch.apps.common import make_mg_preconditioner
from cmfem_tpu_torch.core import (
    FESpace, load_gmsh, make_cartesian_mesh_2d, write_gmsh,
)
from cmfem_tpu_torch.core import pointlocate as tloc
from cmfem_tpu_torch.interop import geometric_mg_from_arrays
from cmfem_tpu_torch.ops import BilinearForm
from cmfem_tpu_torch.solvers import GeometricMG, cg, gmres

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import disc_mesh  # noqa: E402

GEOMS = ["quad", "triangle"]


def _chain(make, geom, order=2, nref=2):
    """specs fine -> coarse: order p then order 1 on the finest mesh, then
    order 1 down the refinement chain, as ``make_mg_preconditioner``."""
    base = make(2, 3, geom=geom)
    chain = [base]
    for _ in range(nref):
        chain.insert(0, chain[0].uniform_refine(1))
    return [(chain[0], order), (chain[0], 1)] + [(m, 1) for m in chain[1:]]


def _form(Form):
    return lambda ops: Form(ops).add_mass(1.0).add_diffusion(
        lambda x: 0.05 * (1.0 + x[:, 0] ** 2))


@pytest.mark.parametrize("geom", GEOMS)
def test_locate_points_and_stencil_equal_jax(geom):
    jspecs, specs = _chain(j_mesh2d, geom), _chain(make_cartesian_mesh_2d, geom)
    for k in range(1, len(specs)):
        jfine, jcoarse = JFESpace(*jspecs[k - 1]), JFESpace(*jspecs[k])
        fine, coarse = FESpace(*specs[k - 1]), FESpace(*specs[k])
        pts = np.asarray(fine.node_positions)
        np.testing.assert_array_equal(pts, np.asarray(jfine.node_positions))
        ej, rj = jloc.locate_points(jcoarse.mesh, pts)
        et, rt = tloc.locate_points(coarse.mesh, pts)
        np.testing.assert_array_equal(et, ej)
        np.testing.assert_array_equal(rt, rj)
        assert (et >= 0).all() and tloc.last_locator in ("numpy", "native")
        dj, wj = jloc.h1_sampling_stencil(jcoarse, pts)
        dt, wt = tloc.h1_sampling_stencil(coarse, pts)
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(wt, wj)
        # interpolation of a linear function is exact
        lin = 1.0 + 2.0 * np.asarray(coarse.node_positions)[:, 0]
        np.testing.assert_allclose((wt * lin[dt]).sum(1), 1.0 + 2.0 * pts[:, 0],
                                   atol=1e-12)
    # points outside the mesh: not found, NaN weights
    out = np.array([[2.0, 2.0], [0.5, 0.5]])
    e, _ = tloc.locate_points(coarse.mesh, out)
    assert e[0] == -1 and e[1] >= 0
    _, w = tloc.h1_sampling_stencil(coarse, out)
    assert np.isnan(w[0]).all() and np.isfinite(w[1]).all()


def test_sampling_functions_equal_jax():
    jfes = JFESpace(j_mesh2d(3, 3, geom="triangle"), 2)
    fes = FESpace(make_cartesian_mesh_2d(3, 3, geom="triangle"), 2)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(fes.nscalar)
    ev = rng.standard_normal(fes.mesh.num_elements)
    pts = rng.uniform(-0.1, 1.1, (40, 2))
    for name, args, jargs in (
            ("sample_h1", (fes, u, pts), (jfes, u, pts)),
            ("sample_h1_grad", (fes, u, pts), (jfes, u, pts)),
            ("sample_l2", (fes.mesh, ev, pts), (jfes.mesh, ev, pts))):
        np.testing.assert_array_equal(getattr(tloc, name)(*args),
                                      getattr(jloc, name)(*jargs))
    assert tloc.front_depth(fes.mesh, ev, 0.5, 1.0, 0.0, 0.1) == \
        jloc.front_depth(jfes.mesh, ev, 0.5, 1.0, 0.0, 0.1)


def test_native_loader_says_when_the_library_is_absent(tmp_path, monkeypatch):
    """No library at the path: one RuntimeWarning, None, nothing built, and
    the callers take their numpy versions."""
    import warnings

    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    with pytest.warns(RuntimeWarning, match="native library not loaded"):
        assert native.load_native() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.load_native() is None  # said once
        path = write_gmsh(disc_mesh(4), str(tmp_path / "disc.msh"))
        assert native.gmsh_parse_native(path) is None
        mesh = load_gmsh(path)
    assert list(tmp_path.iterdir()) == [tmp_path / "disc.msh"]
    np.testing.assert_array_equal(
        mesh.elem_conn, load_gmsh(path, use_native=False).elem_conn)


def test_native_loader_and_gmsh_parser(tmp_path):
    """With the native library: its gmsh parser gives the Python reader's
    mesh, and its bucket-grid candidates give the numpy sweep's elements.
    Without it the loader returns None and both fall back."""
    mesh = disc_mesh(6)
    path = write_gmsh(mesh, str(tmp_path / "disc.msh"))
    py = load_gmsh(path, use_native=False)
    np.testing.assert_allclose(py.vertices, mesh.vertices, rtol=0, atol=0)
    np.testing.assert_array_equal(py.elem_conn, mesh.elem_conn)
    assert abs(np.linalg.norm(py.vertices, axis=1).max() - 1.0) < 1e-12
    jm = j_load_gmsh(path, use_native=False)
    np.testing.assert_array_equal(py.vertices, jm.vertices)
    np.testing.assert_array_equal(py.bdr_conn, jm.bdr_conn)
    if native.load_native() is None:
        assert native.gmsh_parse_native(path) is None
        return
    nat = load_gmsh(path)
    for f in ("vertices", "elem_conn", "elem_attr", "bdr_conn", "bdr_attr"):
        np.testing.assert_array_equal(getattr(nat, f), getattr(py, f))
    assert (nat.geom, nat.bdr_geom, nat.dim) == (py.geom, py.bdr_geom, py.dim)
    # more than 2^20 (point, element) pairs: the native candidate stage
    big = make_cartesian_mesh_2d(24, 24, geom="triangle")
    pts = np.random.default_rng(1).uniform(0, 1, (1000, 2))
    e_nat, r_nat = tloc.locate_points(big, pts)
    assert tloc.last_locator == "native"
    e_np, r_np = tloc.locate_points(big, pts[:500])
    assert tloc.last_locator == "numpy"
    np.testing.assert_array_equal(e_nat[:500], e_np)
    np.testing.assert_array_equal(r_nat[:500], r_np)


def _level_arrays(jmg):
    out = []
    for lvl in jmg.levels:
        d = lvl["data"]
        a = {"data": tuple(None if b is None else np.asarray(b)
                           for b in (d.d00, d.d01, d.d10, d.d11)),
             "diag": np.asarray(lvl["diag"]), "mask": np.asarray(lvl["mask"]),
             "lmax": lvl["lmax"]}
        if "Pd" in lvl:
            a["Pd"], a["Pw"] = np.asarray(lvl["Pd"]), np.asarray(lvl["Pw"])
        out.append(a)
    return out


@pytest.fixture(scope="module", params=GEOMS)
def hierarchies(request):
    geom = request.param
    jmg = JGeometricMG.build(_chain(j_mesh2d, geom), _form(JForm))
    specs = _chain(make_cartesian_mesh_2d, geom)
    carried = geometric_mg_from_arrays(specs, _form(BilinearForm),
                                       _level_arrays(jmg), device="cpu")
    own = GeometricMG.build(specs, _form(BilinearForm), device="cpu")
    return jmg, carried, own


def test_carried_levels_equal_own_build(hierarchies):
    jmg, carried, own = hierarchies
    assert len(carried.levels) == len(own.levels) == len(jmg.levels) == 4
    for lc, lo, lj in zip(carried.levels, own.levels, jmg.levels):
        for f in ("d00", "d11"):
            torch.testing.assert_close(getattr(lc["data"], f),
                                       getattr(lo["data"], f),
                                       rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(lc["diag"], lo["diag"], rtol=1e-12,
                                   atol=1e-14)
        assert torch.equal(lc["mask"], lo["mask"]) and lc["n"] == lo["n"]
        if "Pd" in lo:
            assert torch.equal(lc["Pd"], lo["Pd"])
            assert torch.equal(lc["Pw"], lo["Pw"])
        assert "Pd" in lo or lo is own.levels[-1]
        # another start vector: 20 power iterations agree to some percent
        assert abs(lo["lmax"] / lj["lmax"] - 1.0) < 0.15


def test_vcycle_matches_jax(hierarchies):
    jmg, carried, _ = hierarchies
    Mj, aj = jmg.bind()
    Mt, at = carried.bind()
    n = jmg.levels[0]["n"]
    r = np.random.default_rng(2).standard_normal(n)
    zj = np.asarray(Mj(jnp.asarray(r), aj))
    zt = Mt(torch.as_tensor(r), at).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-10 * np.abs(zj).max())


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_krylov_iterations_match_jax(hierarchies, solver):
    jmg, carried, own = hierarchies
    n = jmg.levels[0]["n"]
    b = np.random.default_rng(3).standard_normal(n)
    results = []
    for mg, where, asarray, (s_cg, s_gmres) in (
            (jmg, jnp.where, jnp.asarray, (jcg, jgmres)),
            (carried, torch.where, torch.as_tensor, (cg, gmres)),
            (own, torch.where, torch.as_tensor, (cg, gmres))):
        M, arrays = mg.bind()
        lvl = mg.levels[0]
        form, data, mask = lvl["form"], lvl["data"], lvl["mask"]
        A = lambda v: where(mask, v, form.apply(data, where(mask, 0.0, v)))
        rhs = where(mask, 0.0, asarray(b))
        if solver == "cg":
            res = s_cg(A, rhs, M=lambda r: M(r, arrays), rtol=1e-10,
                       maxiter=100)
        else:
            res = s_gmres(A, rhs, M=lambda r: M(r, arrays), rtol=1e-10,
                          restart=30, maxiter=10)
        assert bool(res.converged)
        results.append(res)
    rj, rc, ro = results
    its = lambda r: int(r.iters) if solver == "cg" else int(r.inner_iters)
    assert its(rc) == its(rj) and its(rj) <= 25
    assert abs(its(ro) - its(rj)) <= 1
    np.testing.assert_allclose(np.asarray(rc.x), np.asarray(rj.x), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(rj.x)).max())


def test_non_nested_hierarchy_raises():
    fine = make_cartesian_mesh_2d(4, 4, sx=2.0)
    coarse = make_cartesian_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="non-nested"):
        GeometricMG.build([(fine, 1), (coarse, 1)], _form(BilinearForm),
                          device="cpu")


@pytest.mark.parametrize("geom,order,nref,levels", [
    ("triangle", 2, 1, 3), ("quad", 1, 2, 3), ("quad", 3, 0, 2)])
def test_make_mg_preconditioner_from_cfg(tmp_path, capsys, geom, order, nref,
                                         levels):
    path = write_gmsh(make_cartesian_mesh_2d(3, 3, geom=geom),
                      str(tmp_path / "m.msh"))
    cfg = {"mesh_file": path, "serial_ref_levels": nref}
    M = make_mg_preconditioner(cfg, order, _form(BilinearForm), device="cpu")
    assert f"MG hierarchy: {levels} levels" in capsys.readouterr().out
    mesh = load_gmsh(path).uniform_refine(nref) if nref else load_gmsh(path)
    fes = FESpace(mesh, order)
    from cmfem_tpu_torch.ops import SpaceOps
    form = _form(BilinearForm)(SpaceOps(fes, device="cpu"))
    data = form.assemble()
    mask = torch.zeros(fes.nscalar, dtype=torch.bool)
    mask[torch.as_tensor(fes.boundary_dofs().astype(np.int64))] = True
    A = lambda v: torch.where(mask, v, form.apply(
        data, torch.where(mask, 0.0, v)))
    b = torch.where(mask, 0.0, torch.as_tensor(
        np.random.default_rng(4).standard_normal(fes.nscalar)))
    res = cg(A, b, M=M, rtol=1e-10, maxiter=60)
    assert res.converged and res.iters <= 25


def test_make_mg_preconditioner_needs_a_hierarchy(tmp_path):
    path = write_gmsh(make_cartesian_mesh_2d(2, 2), str(tmp_path / "m.msh"))
    with pytest.raises(ValueError, match="hierarchy"):
        make_mg_preconditioner({"mesh_file": path}, 1, _form(BilinearForm),
                               device="cpu")
