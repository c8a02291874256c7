"""Port parity, ``cmfem_tpu_torch.scripts.accuracy_table`` and
``compensated_dots``: column A (float64 on the CPU) of ``linear_cd_2d`` and
``diffusion_mms`` equals the JAX driver's error on the same port-written
mesh file to 1e-10 relative, and a float32 row stays near it; the
compensated-dot system at N = 4 in float64 takes the JAX script's CG
iterations with each dot, x to 1e-10 of JAX's ``cg``."""

import importlib

import numpy as np
import pytest
import torch

from torch_scripts_helpers import jax_script

from cmfem_tpu_torch.scripts import accuracy_table, compensated_dots


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("acc"))
    return d, {name: (mod, cfg, err, fkey) for name, mod, cfg, err, fkey
               in accuracy_table.cases(d, n=8)}


@pytest.mark.parametrize("name", ["linear_cd_2d", "diffusion_mms"])
def test_column_a_matches_jax(rows, name, tmp_path):
    d, table = rows
    mod, cfg, err, fkey = table[name]
    got = accuracy_table.run_case(mod, cfg, err, fkey, str(tmp_path / "p"),
                                  torch.device("cpu"), torch.float64)
    jrun = importlib.import_module(f"cmfem_tpu.apps.{mod}").run
    o = jrun({**cfg, "save_paraview": False,
              "output_path": str(tmp_path / "j")})
    ref = float(err(o))
    assert abs(got["err_vs_analytic"] - ref) <= 1e-10 * abs(ref)
    field = np.asarray(o[fkey], np.float64)
    assert np.linalg.norm(got["field"] - field) \
        <= 1e-8 * np.linalg.norm(field)


def test_float32_row_near_float64(rows):
    """``run_all`` in both modes on one row: the float32 field within 1e-4
    of the float64 one (column C), its error within 1% of column A."""
    d, _ = rows
    cpu = torch.device("cpu")
    a = accuracy_table.run_all("f64", cpu, d, names={"diffusion_mms"})
    b = accuracy_table.run_all("f32", cpu, d, names={"diffusion_mms"})
    assert set(a) == set(b) == {"diffusion_mms"}
    fa, fb = a["diffusion_mms"]["field"], b["diffusion_mms"]["field"]
    assert np.linalg.norm(fb - fa) <= 1e-4 * np.linalg.norm(fa)
    ea, eb = (r["diffusion_mms"]["err_vs_analytic"] for r in (a, b))
    assert abs(eb - ea) <= 1e-2 * ea


@pytest.mark.parametrize("message, recorded", [
    ("Linear solver failed at step 1: residual 1.08e-06", True),
    ("CUDA error: unspecified launch failure", False)])
def test_float32_rows_record_only_the_solver_stop(rows, monkeypatch,
                                                  message, recorded):
    """In float32 a row records the driver's linear-solve stop as
    ``failed``; every other RuntimeError propagates."""
    d, _ = rows

    def stop(*args):
        raise RuntimeError(message)

    monkeypatch.setattr(accuracy_table, "run_case", stop)
    run = lambda: accuracy_table.run_all("f32", torch.device("cpu"), d,
                                         names={"diffusion_mms"})
    if recorded:
        assert run() == {"diffusion_mms": {"failed": message}}
    else:
        with pytest.raises(RuntimeError, match="launch failure"):
            run()


def test_float64_mode_runs_on_the_cpu_only_when_asked(monkeypatch,
                                                      tmp_path):
    """Column A is the CPU's: without --cpu (or CMFEM_FORCE_CPU=1) the
    float64 mode refuses to run, naming why."""
    monkeypatch.delenv("CMFEM_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="float64 oracle on the CPU"):
        accuracy_table.main(["f64", "--out-dir", str(tmp_path)])
    assert not (tmp_path / "acc_ref.npz").exists()


@pytest.mark.parametrize("neumaier", [False, True])
def test_compensated_dots_cg_matches_jax(neumaier):
    import jax.numpy as jnp

    from cmfem_tpu.solvers import cg, jacobi_preconditioner
    from cmfem_tpu.solvers.krylov import neumaier_dot as jdot

    from cmfem_tpu_torch.solvers.krylov import neumaier_dot

    J = jax_script("compensated_dots")
    J.N = 4
    _, apply_A, b, Mdiag = J.build(jnp.float64)
    for rtol in (3e-7, 1e-12):
        jres = cg(apply_A, b, M=jacobi_preconditioner(Mdiag), rtol=rtol,
                  maxiter=3000, dot=jdot if neumaier else None)
        system = compensated_dots.build(4, torch.float64,
                                        torch.device("cpu"))
        assert system[0] == b.shape[0]
        assert np.array_equal(system[2].numpy(), np.asarray(b))
        res = compensated_dots.solve(system, rtol,
                                     neumaier_dot if neumaier else None)
        assert res.iters == int(jres.iters) and res.converged
        jx = np.asarray(jres.x)
        assert np.linalg.norm(res.x.numpy() - jx) \
            <= 1e-10 * np.linalg.norm(jx)


def test_compensated_dots_run_on_the_cpu():
    """``run`` with the CPU as the card: the oracle and both float32 solves
    (N = 4), each float32 solution within 1e-5 of the oracle."""
    out = compensated_dots.run(4, torch.device("cpu"))
    assert out["ndofs"] == 9 ** 3 and out["platform"] == "cpu"
    for name in ("plain_vdot", "neumaier"):
        assert out[name]["rel_l2_vs_f64_oracle"] <= 1e-5
        assert out[name]["iters"] > 0


def _neumaier_tensor_loop(a, b, chunks=256):
    """``neumaier_dot`` as it was, the compensation in 0-d tensor ops."""
    p = a.reshape(-1) * b.reshape(-1)
    n = p.shape[0]
    c = min(chunks, n)
    p = torch.nn.functional.pad(p, (0, (-n) % c)).reshape(c, -1)
    partials = torch.sum(p, dim=1)
    s = torch.zeros((), dtype=p.dtype, device=p.device)
    comp = torch.zeros_like(s)
    for v in partials:
        t = s + v
        comp = comp + torch.where(torch.abs(s) >= torch.abs(v),
                                  (s - t) + v, (v - t) + s)
        s = t
    return s + comp


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_neumaier_dot_equals_the_tensor_loop(dtype):
    """The compensation in numpy scalars gives the tensor loop's bits."""
    from cmfem_tpu_torch.solvers.krylov import neumaier_dot

    rng = np.random.default_rng(11)
    for n, chunks in ((117_649, 256), (1001, 7), (5, 256), (4096, 64)):
        a = torch.as_tensor(rng.standard_normal(n) * 10.0 ** rng.integers(
            -3, 4, n), dtype=dtype)
        b = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
        got = neumaier_dot(a, b, chunks)
        ref = _neumaier_tensor_loop(a, b, chunks)
        assert got.dtype == dtype and got.shape == ()
        assert got.item() == ref.item(), (n, chunks)


@pytest.mark.gpu
def test_neumaier_dot_equals_the_tensor_loop_on_the_card():
    """On CUDA tensors: the same bits as the tensor loop on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmfem_tpu_torch.solvers.krylov import neumaier_dot

    rng = np.random.default_rng(12)
    for dtype in (torch.float32, torch.float64):
        a, b = (torch.as_tensor(rng.standard_normal(117_649), dtype=dtype,
                                device="cuda") for _ in range(2))
        got = neumaier_dot(a, b)
        assert got.device.type == "cuda" and got.dtype == dtype
        assert got.item() == _neumaier_tensor_loop(a, b).item()
