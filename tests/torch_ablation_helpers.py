"""Shared set-up of the ablation parity tests: one strip mesh, the synthetic
TACOT deck and a mid-heating (T, p, extent) state in both packages."""

import os

import jax.numpy as jnp
import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "tacot_synthetic.json")
DT = 0.1
TOP = 3          # make_strip_mesh_2d's top boundary attribute


def strip_file(tmpdir, nx, ny):
    from cmfem_tpu_torch.core import make_strip_mesh_2d, write_gmsh

    return write_gmsh(make_strip_mesh_2d(nx, ny),
                      os.path.join(str(tmpdir), f"strip_{nx}x{ny}.msh"))


def heating_fields(xy, hot=1.0, gas=1.0):
    """A wall-heated (T, p) over the strip's nodes: hot and pressurised near
    the top y = 0.05, 300 K and 0.1 atmosphere below (a low-pressure
    environment, inside the deck's table range)."""
    depth = 0.05 - xy[:, 1]
    T = 300.0 + hot * 1344.0 * np.exp(-depth / 0.004) \
        + 5.0 * np.sin(300.0 * xy[:, 0])
    p = 1.0e4 + gas * 2.0e4 * np.exp(-depth / 0.006)
    return T, p


def ablation_pair(tmpdir, nx, ny, order):
    """Both packages' AblationSystem on one strip file, the JAX state after a
    long step of the cooler field (extents part-way), carried into the port
    with ``ablation_state_from_numpy``, the step's inputs (the new (T, p),
    the old QP values and dt) and the JAX geometric factors as a port
    ``GeometricFactors`` (``gf``)."""
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

    path = strip_file(tmpdir, nx, ny)
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
