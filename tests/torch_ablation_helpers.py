"""Shared set-up of the ablation parity tests: one strip mesh, the synthetic
TACOT deck and a mid-heating (T, p, extent) state in both packages.  JAX is
imported by the functions that use it, so that a module of torch-only tests
(the card's) imports this one on a machine without JAX."""

import os

import numpy as np
import pytest
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "tacot_synthetic.json")
DT = 0.1
TOP = 3          # make_strip_mesh_2d's top boundary attribute


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while a module's parity runs run (imported
    by the ablation test modules): their strips are small, so the threads
    only contend with the other test workers' for the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def strip_file(tmpdir, nx, ny, geom="quad"):
    """A graded strip's GMSH file (``geom``: "quad" or "triangle")."""
    from cmfem_tpu_torch.core import make_strip_mesh_2d, write_gmsh

    return write_gmsh(make_strip_mesh_2d(nx, ny, geom=geom),
                      os.path.join(str(tmpdir),
                                   f"strip_{geom}_{nx}x{ny}.msh"))


def heating_fields(xy, hot=1.0, gas=1.0):
    """A wall-heated (T, p) over the strip's nodes: hot and pressurised near
    the top y = 0.05, 300 K and 0.1 atmosphere below (a low-pressure
    environment, inside the deck's table range)."""
    depth = 0.05 - xy[:, 1]
    T = 300.0 + hot * 1344.0 * np.exp(-depth / 0.004) \
        + 5.0 * np.sin(300.0 * xy[:, 0])
    p = 1.0e4 + gas * 2.0e4 * np.exp(-depth / 0.006)
    return T, p


def ablation_pair(tmpdir, nx, ny, order, geom="quad"):
    """Both packages' AblationSystem on one strip file, the JAX state after a
    long step of the cooler field (extents part-way), carried into the port
    with ``ablation_state_from_numpy``, the step's inputs (the new (T, p),
    the old QP values and dt) and the JAX geometric factors as a port
    ``GeometricFactors`` (``gf``)."""
    import jax.numpy as jnp

    from cmfem_tpu.core import FESpace as JFESpace, load_gmsh as jload
    from cmfem_tpu.ops import SpaceOps as JSpaceOps
    from cmfem_tpu.physics.ablation import AblationState as JState
    from cmfem_tpu.physics.ablation import AblationSystem as JSystem
    from cmfem_tpu.physics.tacot import TacotMaterial as JMat
    from cmfem_tpu_torch.core import FESpace, GeometricFactors, load_gmsh
    from cmfem_tpu_torch.interop import ablation_state_from_numpy
    from cmfem_tpu_torch.ops import SpaceOps
    from cmfem_tpu_torch.physics.ablation import AblationSystem
    from cmfem_tpu_torch.physics.tacot import TacotMaterial

    path = strip_file(tmpdir, nx, ny, geom)
    qo = max(2, 2 * order + 2)
    jfes = JFESpace(jload(path), order)
    jsys = JSystem(JSpaceOps(jfes, quad_order=qo), JMat.load_yaml(FIXTURE),
                   gravity=(0.0, -9.81), top_attr=TOP)
    fes = FESpace(load_gmsh(path), order)
    psys = AblationSystem(SpaceOps(fes, quad_order=qo, device="cpu"),
                          TacotMaterial.load_yaml(FIXTURE),
                          gravity=(0.0, -9.81), top_attr=TOP)
    xy = np.asarray(fes.node_positions)
    # the gas pressure builds up within the step.  The p residual carries
    # the roundoff of the p gradients (|p| cancels to |grad p| h), which
    # the packages sum in different orders: at one atmosphere it reaches
    # ~1e-12 of max|R_p| on the order-2 strip, at 0.1 atmosphere ~1e-13
    To, po = heating_fields(xy, hot=0.7, gas=0.0)
    T, p = heating_fields(xy, hot=1.0)
    jstate = jsys.advance_state(
        JState.initial(jsys.ne, jsys.nq, jsys.mat), jnp.asarray(To),
        jnp.asarray(po), 1.0)
    state = ablation_state_from_numpy(jstate, device="cpu")
    t = lambda a: torch.tensor(np.asarray(a))
    # the JAX package's geometric factors, so that the residual and the
    # Jacobians see the same geometry: the two packages' factors of a graded
    # strip differ by ~1e-14, which the Darcy term's cancellation amplifies
    jgf = jsys.ops.gf
    gf = GeometricFactors(t(jgf.detJ), t(jgf.invJ), t(jgf.wdetJ), t(jgf.xq))
    return {
        "jsys": jsys, "psys": psys, "jstate": jstate, "state": state,
        "fes": fes, "T": T, "p": p, "gf": gf,
        "jargs": (jnp.asarray(T), jnp.asarray(p),
                  jsys.ops.values_at_qp(jnp.asarray(To)),
                  jsys.ops.values_at_qp(jnp.asarray(po)),
                  jnp.asarray(jstate.extent), DT),
        "pargs": (t(T), t(p), psys.ops.values_at_qp(t(To)),
                  psys.ops.values_at_qp(t(po)), state.extent, DT),
    }


def rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


# -- the case-2.2 driver parity files ----------------------------------------

FIXTURES = os.path.dirname(FIXTURE)
SCHED = os.path.join(FIXTURES, "surface_bc_case21.dat")
AMARYLLIS = os.path.join(FIXTURES, "amaryllis_mass_synthetic.dat")
CSVS22 = ("temperature_probes.csv", "mass_metrics.csv",
          "boundary_diagnostics.csv",
          "newton_history_ablation_case2_2_2D.csv", "pressure_probes.csv",
          "mesh_diagnostics.csv", "mass_eq_probe_diagnostics.csv")


def case22_cfg(strip, out, **extra):
    """A case-2.2 config on a strip file: the synthetic deck, the schedule
    and Amaryllis fixtures, 6 steps of dt 0.1."""
    return {"mesh_file": strip, "material_file": FIXTURE,
            "boundary_conditions_file": SCHED,
            "amaryllis_mass_file": AMARYLLIS, "order": 1, "dt": 0.1,
            "t_final": 0.6, "bdr_attr_top": TOP, "bdr_attr_bottom": 1,
            "probe_x": 0.00125, "newton_print_level": 0,
            "save_paraview": False, "output_every": 2,
            "output_path": str(out), **extra}


def read_csv(path):
    with open(path) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def newton_counts(path):
    """Linear solves per step, from a Newton CSV (rows per step - 1)."""
    _, rows = read_csv(path)
    steps = rows[:, 0].astype(int)
    return [int((steps == s).sum()) - 1 for s in np.unique(steps)]


def csv_close(a, b, what, rtol=1e-7, floor=1e-12, newton_rtol=1e-7):
    """rtol, with a floor of 1e-12 x the column's largest value (values
    that are zero in one run and roundoff in the other), NaN in the same
    places; the residual and update columns of a Newton CSV to
    ``newton_rtol`` or within ``floor`` x the column's largest value."""
    assert a.shape == b.shape, what
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    a, b = np.nan_to_num(a), np.nan_to_num(b)
    scale = np.abs(b).max(axis=0)
    atol = np.where(scale > 0, 1e-12 * scale, 1e-300)
    rt = np.full(b.shape[1], rtol)
    if what.startswith("newton"):
        cols = [3, 5, 6, 8]
        atol[cols] = floor * scale[cols]
        rt[cols] = newton_rtol
    bad = np.abs(a - b) > rt * np.abs(b) + atol
    assert not bad.any(), (what, np.argwhere(bad)[:5])


def hold_to_jax(d_port, d_jax, floor=1e-12, newton_rtol=1e-7,
                csvs=CSVS22):
    """Every CSV of a port run against the JAX run's: the tolerance echo
    as text, the recession metrics to 1e-12, the rest by ``csv_close``."""
    with open(d_port / "amaryllis_error_tolerances.csv") as fp, \
            open(d_jax / "amaryllis_error_tolerances.csv") as fj:
        assert fp.read() == fj.read()
    metrics = []
    for d in (d_port, d_jax):
        with open(d / "recession_error_metrics.csv") as f:
            metrics.append([line.strip().split(",") for line in f])
    (hp, *a), (hj, *b) = metrics
    assert hp == hj == ["metric", "value"] and len(a) == len(b) == 4
    assert [r[0] for r in a] == [r[0] for r in b]
    np.testing.assert_allclose([float(r[1]) for r in a],
                               [float(r[1]) for r in b], rtol=1e-12, atol=0)
    for name in csvs:
        hp, a = read_csv(d_port / name)
        hj, b = read_csv(d_jax / name)
        assert hp == hj, name
        csv_close(a, b, name, floor=floor, newton_rtol=newton_rtol)


# -- the distributed ablation Newton parity files ----------------------------

BC21 = (101325.0, 0.3, 1.5e6, 10.0, 300.0, True, True, 1)
BC22 = (101325.0, 0.3, 1.5e6, 0.0, 300.0, False, False, 1)


def newton_inputs(tmpdir, nx=3, ny=20, rtol=1e-10):
    """The JAX pair on an order-1 quad strip and the numpy inputs of
    ``torch_dist_helpers.ablation_newton_checks``: the pair's state, and
    three cases, each the Newton system of one class instance:

    - "static": case 1 (T and p essential on the top);
    - "seb": case 2.1's SEB top (chemistry-blowing branch) with an
      outflowing gas pressure;
    - "receded": case 2.2's flux model on the top receded by up to 2%,
      with a seeded downward mesh velocity at the QPs and a GCL pair
      (J_old seeded around the receded J_new)."""
    import jax.numpy as jnp

    from cmfem_tpu.physics import seb as JS
    from cmfem_tpu.physics.surface_bc import BoundaryState

    pair = ablation_pair(tmpdir, nx, ny, 1)
    jsys = pair["jsys"]
    fes = pair["fes"]
    xy = np.asarray(fes.node_positions)
    top = np.asarray(fes.boundary_dofs([TOP]), dtype=np.int64)
    none = np.zeros(0, dtype=np.int64)
    T, p = pair["T"], pair["p"]
    p_out = 2.0e4 + 4.0e5 * (0.05 - xy[:, 1])
    verts = np.asarray(fes.mesh.vertices, dtype=np.float64).copy()
    verts[:, 1] *= 1.0 - 0.02 * (verts[:, 1] / verts[:, 1].max())
    J_new = np.asarray(jsys.ops.geometric_factors(jnp.asarray(verts)).detJ)
    rng = np.random.default_rng(11)
    J_old = J_new * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, J_new.shape))
    wq = np.zeros(J_new.shape + (2,))
    wq[..., 1] = -1e-5 * (1.0 + 0.1 * rng.standard_normal(J_new.shape))
    branch = lambda bc, kw: JS.classify_branch(BoundaryState(*bc),
                                               JS.SurfaceFluxModel(**kw))
    case = lambda **kw: {"ess_T": top, "ess_p": top, "T": T, "p": p,
                         "seb": None, "bc": None, "vertices": None,
                         "wq": None, "gcl": None, **kw}
    cases = {
        "static": case(),
        "seb": case(ess_T=none, p=p_out, bc=BC21,
                    seb=(branch(BC21, {}), {})),
        "receded": case(ess_T=none, bc=BC22,
                        seb=(branch(BC22, {"case22": True}),
                             {"case22": True}),
                        vertices=verts, wq=wq, gcl=(J_old, J_new)),
    }
    assert cases["seb"]["seb"][0] == "chemistry_blowing"
    jgf = jsys.ops.gf
    _, _, To_q, po_q, X, dt = pair["jargs"]
    inp = {"strip": strip_file(tmpdir, nx, ny), "deck": FIXTURE, "top": TOP,
           "gf": tuple(np.asarray(a) for a in (jgf.detJ, jgf.invJ,
                                               jgf.wdetJ, jgf.xq)),
           "To_q": np.asarray(To_q), "po_q": np.asarray(po_q),
           "extent": np.asarray(X), "dt": dt, "rtol": rtol, "cases": cases}
    return pair, inp


def jax_newton(kind, pair, inp, ndev):
    """``newton_inputs``' cases through the JAX package's class (``kind``:
    "sharded" or "dofpart") on ``ndev`` virtual CPU devices: the global
    residual, prepare's factors in the class's global layout, the Newton
    direction and the GMRES counts."""
    import jax.numpy as jnp

    from cmfem_tpu.parallel import (DofPartitionedAblationNewton,
                                    ShardedAblationNewton, make_device_mesh)
    from cmfem_tpu.physics.bprime import BPrimeTable
    from cmfem_tpu.physics.seb import SurfaceFluxModel
    from cmfem_tpu.physics.surface_bc import BoundaryState

    jm = make_device_mesh(ndev)
    jsys = pair["jsys"]
    out = {}
    for name, case in inp["cases"].items():
        seb = None if case["seb"] is None else (
            case["seb"][0], SurfaceFluxModel(**case["seb"][1]),
            BPrimeTable.synthetic_tacot())
        bc = None if case["bc"] is None else BoundaryState(*case["bc"])
        gcl = case["gcl"]
        kw = dict(restart=400, maxiter=10, seb=seb)
        if kind == "sharded":
            nw = ShardedAblationNewton(jsys, jm, case["ess_T"],
                                       case["ess_p"], **kw)
            pack = lambda a, fill="dup": nw.pad_elem(a)
        else:
            nw = DofPartitionedAblationNewton(
                jsys, jm, case["ess_T"], case["ess_p"],
                gcl_enabled=gcl is not None, **kw)
            pack = lambda a, fill="dup": nw.pack_elem(np.asarray(a), fill)
        if case["vertices"] is not None:
            nw.update_geometry(jnp.asarray(case["vertices"]))
        slabs = tuple(pack(a) for a in (inp["To_q"], inp["po_q"],
                                        inp["extent"]))
        ale = dict(bc=bc, wq=None if case["wq"] is None
                   else pack(case["wq"], "zero"),
                   gcl=None if gcl is None else (pack(gcl[0]),
                                                 pack(gcl[1])))
        T, p = jnp.asarray(case["T"]), jnp.asarray(case["p"])
        if kind == "sharded":
            R = nw.residual(T, p, *slabs, inp["dt"], **ale)
            fac = nw.prepare(T, p, *slabs, inp["dt"], **ale)
            res = nw.solve(fac, -R, rtol=inp["rtol"])
            dx = np.asarray(res.x)
        else:
            y = nw.to_dist2(case["T"], case["p"])
            Rd = nw.residual(y, *slabs, inp["dt"], **ale)
            R = np.concatenate(nw.from_dist2(Rd))
            fac = nw.prepare(y, *slabs, inp["dt"], **ale)
            res = nw.solve(fac, -Rd, rtol=inp["rtol"])
            dx = np.concatenate(nw.from_dist2(res.x))
            out.setdefault("per_device_floats", nw.per_device_floats())
        out[name] = {"R": np.asarray(R), "Je_s": np.asarray(fac[0]),
                     "pb": np.asarray(fac[1]), "s": np.asarray(fac[2]),
                     "dx": dx, "iters": int(res.iters),
                     "inner_iters": int(res.inner_iters),
                     "converged": bool(res.converged)}
    return out


def max_rel(a, b):
    """max|a - b| / max|b| (numpy)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())
