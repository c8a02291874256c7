"""Coupled (T, p) porous-medium pyrolysis system (ablation case 1).

Port of the case-1 surface of ``cmfem_tpu/physics/ablation.py`` (the
reference's ``AblationTPIntegrator`` + ``ReactionStateManager``):

- energy residual: solid+gas storage, conduction, Darcy enthalpy advection,
  gravity work, pyrolysis heat sink;
- pressure residual: gas storage, Darcy flux, pyrolysis source;
- per-QP reaction extents advanced by the implicit TACOT extent solve and
  frozen per step (recomputed from the old state inside the residual, so
  AD differentiates through the extent Newton);
- element Jacobian blocks by ``torch.func.vmap(torch.func.jacfwd(...))``;
- element-average diagnostics and the top-boundary Darcy mass-flux
  diagnostic;
- the surface-energy-balance (SEB) face residual of case 2.1, its face
  Jacobian blocks by ``vmap(jacfwd)`` over the boundary faces, and the
  area-averaged boundary terms;
- case 2.2's lumped top-boundary recession velocity and the per-point
  mass-equation probes (host-located, and fed by a ``TrackedSampler`` on
  the device for the scan path).

Everything is batched over (ne, nq) on the device of the ``SpaceOps``.  The
boundary diagnostics and the recession velocity run eagerly: the JAX
package caches one jitted program per flux branch (and density mode),
which has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.assembly import SpaceOps
from ..ops.faces import BoundaryTrace
from .tacot import TacotMaterial
from ..utils.timing import host_sync, span_count

MU_FLOOR = 1.0e-12
# the fields of a BoundaryState that the face-Jacobian graph takes as inputs
_BC_VALUES = ("p_w", "rhoeUeCH", "h_r", "hconv", "Tedge")

@dataclass
class AblationState:
    """Per-QP committed reaction extents (a tensor on the device) and
    element-average diagnostics (numpy)."""

    extent: torch.Tensor           # (ne, nq, nr) committed
    tau_elem: np.ndarray           # (ne,)
    rho_elem: np.ndarray
    pi_elem: np.ndarray
    mdot_elem: np.ndarray
    extent_elem: np.ndarray        # (nr, ne)
    degree_char_elem: np.ndarray
    char_density_fraction_elem: np.ndarray
    pi_qp: np.ndarray | None = None  # (ne, nq) per-QP pyrolysis rate

    @classmethod
    def initial(cls, ne, nq, material: TacotMaterial, *, device,
                dtype=torch.float64):
        nr = material.num_reactions
        return cls(
            extent=torch.zeros((ne, nq, nr), dtype=dtype, device=device),
            tau_elem=np.ones(ne),
            rho_elem=np.full(ne, material.initial_solid_density()),
            pi_elem=np.zeros(ne),
            mdot_elem=np.zeros(ne),
            extent_elem=np.zeros((nr, ne)),
            degree_char_elem=np.zeros(ne),
            char_density_fraction_elem=np.zeros(ne),
            pi_qp=np.zeros((ne, nq)),
        )


def _grad(invJ, gref):
    """Physical gradient from reference gradients: sum_r invJ[r, d] g[r]."""
    return torch.sum(invJ * gref[..., :, None], dim=-2)


class _JacobianGraph:
    """One key's Jacobian blocks as a CUDA graph of ``fn(*args,
    *scalars)``.  The tensor inputs (``None`` where not given, a tuple of
    tensors where a tuple) are copied into static buffers and the scalars
    (host numbers) filled into 0-d device tensors before every replay; no
    host number reaches the card inside the graph.  The graph's memory is
    freed with it, so nothing it holds may refer back to its owner: a
    reference cycle would leave the freeing to the garbage collector, which
    may run inside another graph's capture, where it is not permitted."""

    # one capture stream per device: a stream's cuBLAS workspace is kept
    # for the life of the process
    _streams = {}

    def __init__(self, fn, args, scalars):
        self.device = args[0].device
        with torch.cuda.device(self.device):
            self.inputs = [None if a is None else
                           tuple(torch.empty_like(b) for b in a)
                           if isinstance(a, tuple) else torch.empty_like(a)
                           for a in args]
            self.scalars = tuple(torch.empty((), dtype=args[0].dtype,
                                             device=self.device)
                                 for _ in scalars)
            self._load(args, scalars)
            stream = self._streams.get(self.device)
            if stream is None:
                stream = self._streams[self.device] = torch.cuda.Stream()
            current = torch.cuda.current_stream()
            stream.wait_stream(current)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.outputs = fn(*self.inputs, *self.scalars)
                finally:
                    self.graph.capture_end()
            current.wait_stream(stream)

    def _load(self, args, scalars):
        for buf, a in zip(self.inputs, args):
            if isinstance(buf, tuple):
                for b, x in zip(buf, a):
                    b.copy_(x)
            elif buf is not None:
                buf.copy_(a)
        for buf, x in zip(self.scalars, scalars):
            buf.fill_(x)

    def __call__(self, args, scalars):
        with torch.cuda.device(self.device):
            self._load(args, scalars)
            self.graph.replay()
            return tuple(o.clone() for o in self.outputs)


class AblationSystem:
    """The coupled residual, AD Jacobian, state advance, and diagnostics."""

    def __init__(self, ops: SpaceOps, material: TacotMaterial,
                 gravity=(0.0, 0.0), top_attr: int = 1):
        self.ops = ops
        self.mat = material
        self.gravity = torch.as_tensor(np.asarray(gravity, dtype=np.float64),
                                       dtype=ops.dtype, device=ops.device)
        self.n = ops.fes.nscalar
        self.ne, self.nq = ops.gf.wdetJ.shape
        self.trace = BoundaryTrace(ops, attr_marker=[top_attr])
        self._trace_elem = torch.as_tensor(self.trace.elem, device=ops.device)
        self.lat = None
        # element_jacobians' and seb_face_jacobians' CUDA graphs by key
        # (None: seen once, eager)
        self._graphs = {}

    def set_dof_lattice(self, lat):
        """Take the window-slicing residual path on a tensor-product strip
        mesh (``ops.lattice2d``): the per-element gather and scatter become
        strided windows and overlap-adds (the quadrature work between them
        is the generic path's).  Raises ValueError when the mesh
        elements are not row-major over the cell lattice."""
        from ..ops.lattice2d import StripLatticeOps

        self.lat = StripLatticeOps(self.ops.fes.element_dofs, self.n, lat,
                                   device=self.ops.device)
        return self.lat

    # -- QP-level residual densities --------------------------------------

    def _qp_residual(self, Tq, gTq, pq, gpq, T_old_q, p_old_q, X_old, dt,
                     wq=None, gcl=None,
                     ale_toggles=(True, True, True)):
        """Residual densities at QPs.

        Returns (r0T, r1T, r0p, r1p): test-value and test-gradient weights
        for the energy and pressure equations (all (..., nq[, dim])).
        With a mesh velocity wq (..., nq, dim) the case-2.2 ALE advective
        terms +(eps_g rho)(w . grad psi) and
        +(rho_s cp T + eps_g(rho h - p))(w . grad psi) are added; ``gcl``
        (J_old, J_new) switches the storage terms to their Jacobian-weighted
        geometric-conservation form."""
        mat = self.mat
        X = mat.solve_reaction_extents(Tq, dt, X_old)
        solid = mat.solid_props(Tq, pq, X, extent_old=X_old, dt=dt)
        gas = mat.gas_props(Tq, pq)
        solid_old = mat.solid_props(T_old_q, p_old_q, X_old)
        gas_old = mat.gas_props(T_old_q, p_old_q)

        mu = torch.clamp(gas["mu"], min=MU_FLOOR)
        darcy = solid["K"] / mu
        rho_darcy = gas["rho"] * darcy
        rho2_darcy = gas["rho"] * rho_darcy
        h_rho_darcy = gas["h"] * rho_darcy
        h_rho2_darcy = gas["h"] * rho2_darcy

        ale_mass_on, ale_es_on, ale_eg_on = ale_toggles
        e_m_new = solid["eps_g"] * gas["rho"]
        e_m_old = solid_old["eps_g"] * gas_old["rho"]
        e_s_new = solid["rho_s"] * solid["cp"] * Tq
        e_s_old = solid_old["rho_s"] * solid_old["cp"] * T_old_q
        e_g_new = solid["eps_g"] * (gas["rho"] * gas["h"] - pq)
        e_g_old = solid_old["eps_g"] * (gas_old["rho"] * gas_old["h"]
                                        - p_old_q)
        # plain backward-Euler storage (the solid term uses NEW properties
        # with the temperature difference, as the reference does)
        storage_p = (e_m_new - e_m_old) / dt
        solid_storage = solid["rho_s"] * solid["cp"] * (Tq - T_old_q) / dt
        gas_storage = (e_g_new - e_g_old) / dt
        if gcl is not None:
            J_old, J_new = gcl
            ok = (J_old > 0) & (J_new > 0)
            Jn = torch.where(ok, J_new, 1.0)
            Jo = torch.where(ok, J_old, 1.0)

            def gcl_storage(enabled, enew, eold, plain):
                if not enabled:
                    return plain
                return torch.where(ok, (Jn * enew - Jo * eold) / (Jn * dt),
                                   plain)

            storage_p = gcl_storage(ale_mass_on, e_m_new, e_m_old, storage_p)
            solid_storage = gcl_storage(ale_es_on, e_s_new, e_s_old,
                                        solid_storage)
            gas_storage = gcl_storage(ale_eg_on, e_g_new, e_g_old,
                                      gas_storage)
        source_p = solid["pi_total"]

        g = self.gravity
        r0p = storage_p - source_p
        r1p = rho_darcy[..., None] * gpq - rho2_darcy[..., None] * g
        r0T = solid_storage + gas_storage - solid["pyrolysis_heat_sink"]
        r1T = (solid["k"][..., None] * gTq
               + h_rho_darcy[..., None] * gpq
               - h_rho2_darcy[..., None] * g)
        if wq is not None:
            ale_mass = e_m_new if ale_mass_on else torch.zeros_like(e_m_new)
            ale_energy = ((e_s_new if ale_es_on else 0.0)
                          + (e_g_new if ale_eg_on else 0.0))
            r1p = r1p + ale_mass[..., None] * wq
            if ale_es_on or ale_eg_on:
                r1T = r1T + ale_energy[..., None] * wq
        return r0T, r1T, r0p, r1p

    # -- global residual ---------------------------------------------------

    def residual(self, T, p, T_old_q, p_old_q, X_old, dt, gf=None, wq=None,
                 gcl=None, ale_toggles=(True, True, True)):
        """Global block residual (R_T, R_p) for dof vectors T, p (n,)."""
        ops = self.ops
        gf = gf or ops.gf
        lp = self.lat
        if lp is not None:
            T_e = lp.gather_elem(lp.to_lat(T))
            p_e = lp.gather_elem(lp.to_lat(p))
        else:
            T_e, p_e = T[ops.eldofs], p[ops.eldofs]
        Tq = torch.einsum("qn,en->eq", ops.B, T_e)
        pq = torch.einsum("qn,en->eq", ops.B, p_e)
        gTref = torch.einsum("qnr,en->eqr", ops.G, T_e)
        gpref = torch.einsum("qnr,en->eqr", ops.G, p_e)
        gT, gp = _grad(gf.invJ, gTref), _grad(gf.invJ, gpref)
        r0T, r1T, r0p, r1p = self._qp_residual(
            Tq, gT, pq, gp, T_old_q, p_old_q, X_old, dt, wq=wq, gcl=gcl,
            ale_toggles=ale_toggles)

        def scatter_pair(r0, r1):
            y_e = torch.einsum("qn,eq->en", ops.B, r0 * gf.wdetJ)
            r1ref = torch.sum(gf.invJ * r1[..., None, :], dim=-1)
            y_e = y_e + torch.einsum("qnr,eqr->en", ops.G,
                                     r1ref * gf.wdetJ[..., None])
            return lp.scatter(y_e) if lp is not None else ops.scatter(y_e)

        return scatter_pair(r0T, r1T), scatter_pair(r0p, r1p)

    # -- element Jacobian blocks ------------------------------------------

    def elem_residual_fn(self, dt, gcl_enabled=False,
                         ale_toggles=(True, True, True)):
        """Single-element residual closure
        ``elem_res(elT, elp, invJ, wdetJ, To, po, Xo, wqe, Jo, Jn) ->
        (rT (nd,), rp (nd,))``: the per-element quadrature work of the
        global residual.  It never scatters (``vmap`` refuses an in-place
        ``index_add_`` into an unbatched target)."""
        B, G = self.ops.B, self.ops.G

        def elem_res(elT, elp, invJ, wdetJ, To, po, Xo, wqe, Jo, Jn):
            Tq = (B @ elT)[None]
            pq = (B @ elp)[None]
            gT = _grad(invJ, torch.einsum("qnr,n->qr", G, elT))[None]
            gp = _grad(invJ, torch.einsum("qnr,n->qr", G, elp))[None]
            r0T, r1T, r0p, r1p = self._qp_residual(
                Tq, gT, pq, gp, To[None], po[None], Xo[None], dt,
                wq=wqe[None],
                gcl=(Jo[None], Jn[None]) if gcl_enabled else None,
                ale_toggles=ale_toggles)

            def pair(r0, r1):
                y = B.T @ (r0[0] * wdetJ)
                r1ref = torch.sum(invJ * r1[0][..., None, :], dim=-1)
                return y + torch.einsum("qnr,qr->n", G,
                                        r1ref * wdetJ[:, None])

            return pair(r0T, r1T), pair(r0p, r1p)

        return elem_res

    def element_jacobians(self, T, p, T_old_q, p_old_q, X_old, dt, gf=None,
                          wq=None, gcl=None, ale_toggles=(True, True, True)):
        """(ne, nd, nd) x4 Jacobian blocks d(rT,rp)/d(elT,elp) by forward AD,
        all elements in one ``vmap(jacfwd)``.  The JAX package chunks the
        element axis (``CMFEM_ELEMJAC_CHUNK``) for its TPU memory; here the
        blocks of the largest mesh run (42k order-1 quads) take 21 MB in
        float64 and the transform's working set a few hundred, so there is
        no chunking.

        The JAX package jits the call; here its ~3,000 small kernels are
        launched one by one from the host, so on a CUDA device the call is
        kept as a CUDA graph, one per key (shapes, dtype, device, which of
        ``wq``/``gcl`` are given, ``ale_toggles``): a key's first call runs
        eagerly (it warms the transforms, the allocator and the material's
        device constants), its second captures the graph and replays it,
        and every later call copies its inputs into the graph's buffers and
        replays it.  The blocks returned are copies, so a later replay
        leaves them be.  On the CPU every call is eager.  Each call counts
        ``jacobian_eager``, ``jacobian_captures`` or ``jacobian_replays`` on
        the timer whose span is open."""
        gf = gf or self.ops.gf
        ale_toggles = tuple(bool(a) for a in ale_toggles)
        args = (T, p, gf.invJ, gf.wdetJ, T_old_q, p_old_q, X_old, wq,
                None if gcl is None else tuple(gcl))
        key = (self.ne, self.nq, self.ops.eldofs.shape[1], X_old.shape[-1],
               T.dtype, T.device, wq is not None, gcl is not None,
               ale_toggles)
        return self._by_key(
            "jacobian", key,
            lambda: self._element_jacobians(*args, dt, ale_toggles),
            lambda: self._capture_jacobians(args, dt, ale_toggles),
            args, (dt,))

    def _by_key(self, name, key, eager, capture, args, scalars):
        """A key's Jacobian call: ``eager()`` on the CPU, and on a CUDA
        device at the key's first call; its second call ``capture()``s a
        ``_JacobianGraph`` and replays it, later calls replay it at
        ``args`` and ``scalars`` (a capture that returns None leaves every
        call eager).  Counts ``<name>_eager``, ``<name>_captures`` or
        ``<name>_replays`` on the timer whose span is open."""
        if args[0].device.type != "cuda":
            span_count(name + "_eager")
            return eager()
        graph, kind = self._graphs.get(key), name + "_replays"
        if graph is None and key in self._graphs:
            graph = self._graphs[key] = capture()
            kind = name + "_captures"
        if graph is None:
            self._graphs[key] = None
            span_count(name + "_eager")
            return eager()
        span_count(kind)
        return graph(args, scalars)

    def _element_jacobians(self, T, p, invJ, wdetJ, T_old_q, p_old_q, X_old,
                           wq, gcl, dt, ale_toggles):
        if wq is None:
            wq = torch.zeros(wdetJ.shape + (invJ.shape[-1],),
                             dtype=wdetJ.dtype, device=wdetJ.device)
        if gcl is None:
            neg = torch.full_like(wdetJ, -1.0)
            gcl_arrs = (neg, neg)
        else:
            gcl_arrs = gcl
        elem_res = self.elem_residual_fn(dt, gcl_enabled=gcl is not None,
                                         ale_toggles=ale_toggles)
        jac = torch.func.vmap(torch.func.jacfwd(elem_res, argnums=(0, 1)))
        eldofs = self.ops.eldofs
        (JTT, JTp), (JpT, Jpp) = jac(T[eldofs], p[eldofs], invJ, wdetJ,
                                     T_old_q, p_old_q, X_old, wq, *gcl_arrs)
        return JTT, JTp, JpT, Jpp

    def _capture_jacobians(self, args, dt, ale_toggles):
        """The CUDA graph of ``_element_jacobians`` at these arguments'
        key (``_JacobianGraph``): the extent sweeps run to their cap there,
        each frozen where the eager loop would stop
        (``tacot._extent_sweeps``)."""
        return _JacobianGraph(
            lambda *a: self._element_jacobians(*a, ale_toggles), args, (dt,))

    # -- checks, state advance, diagnostics -------------------------------

    def jacobian_check(self, T, p, T_old_q, p_old_q, X_old, dt,
                       abs_tol=1e-6, rel_tol=1e-4, n_dirs=3, fd_eps=1e-7,
                       gf=None, wq=None, gcl=None,
                       ale_toggles=(True, True, True), seed=0,
                       seb=None, bc=None, vertices=None,
                       skip_nonsmooth=True):
        """AD-vs-FD Jacobian consistency check (the reference's opt-in
        jacobian_check): the element-block-assembled Jacobian action J v is
        compared against a central finite-difference directional derivative
        of the global residual for n_dirs random directions.  Raises with
        the argmax row on mismatch; returns the max relative error.

        With ``seb=(branch, model, bprime)`` and ``bc`` the SEB face blocks
        are assembled into the test matrix and the face residual into R,
        and the face blocks are then checked alone against an FD of the
        face residual, with their own scale (a direction that fails is
        retried once at h/8 with a fresh direction: a central difference
        straddling an interior spline knot shrinks with h, a Jacobian
        error does not).  States where the B' table clamps with chemistry
        on (non-smooth: the central FD straddles the kink the AD zeroes on
        one side) are skipped: returns None when ``skip_nonsmooth``.  The
        directions come from ``numpy.random.default_rng(seed)``, in the
        JAX package's order."""
        import scipy.sparse as sp

        if seb is not None:
            branch, model, bprime = seb
            chem_on = bc is not None and int(bc.chemistryOn) != 0
            if skip_nonsmooth and bprime is not None and chem_on:
                # clamps make the residual non-smooth only when the B'
                # outputs enter the flux (chemistry on)
                Xrep = X_old[self._trace_elem, 0]
                terms = self.top_boundary_terms(T, p, Xrep, bc, branch,
                                                model, bprime,
                                                vertices=vertices)
                nclamp = float(terms["clamps_p"] + terms["clamps_bg"]
                               + terms["clamps_t"])
                if nclamp > 0:
                    return None
        blocks = self.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt,
                                        gf=gf, wq=wq, gcl=gcl,
                                        ale_toggles=ale_toggles)
        n = self.n
        ed = np.asarray(self.ops.fes.element_dofs, dtype=np.int64)
        nd = ed.shape[1]
        rows_b = np.repeat(ed, nd, axis=1).reshape(-1)
        cols_b = np.tile(ed, (1, nd)).reshape(-1)
        rows = np.concatenate([rows_b, rows_b, rows_b + n, rows_b + n])
        cols = np.concatenate([cols_b, cols_b + n, cols_b, cols_b + n])
        host = lambda b: b.detach().cpu().numpy().reshape(-1)
        vals = np.concatenate([host(b) for b in blocks])
        if seb is not None:
            JTf, Jpf = self.seb_face_jacobians(T, p, X_old, bc, branch,
                                               model, bprime,
                                               vertices=vertices)
            fed = self.trace.eldofs.cpu().numpy()
            ndf = fed.shape[1]
            rows_f = np.repeat(fed, ndf, axis=1).reshape(-1)
            cols_f = np.tile(fed, (1, ndf)).reshape(-1)
            face_vals = np.concatenate([host(JTf), host(Jpf)])
            rows = np.concatenate([rows, rows_f, rows_f])
            cols = np.concatenate([cols, cols_f, cols_f + n])
            vals = np.concatenate([vals, face_vals])
        J = sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, 2 * n)).tocsr()
        dev, dtype = T.device, T.dtype
        tens = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)

        def R(x):
            xt = tens(x)
            RT, Rp = self.residual(xt[:n], xt[n:], T_old_q, p_old_q, X_old,
                                   dt, gf=gf, wq=wq, gcl=gcl,
                                   ale_toggles=ale_toggles)
            if seb is not None:
                RT = RT + self.seb_face_residual(xt[:n], xt[n:], X_old, bc,
                                                 branch, model, bprime,
                                                 vertices=vertices)
            return torch.cat([RT, Rp]).cpu().numpy()

        x0 = torch.cat([T, p]).cpu().numpy()
        rng = np.random.default_rng(seed)

        def direction():
            v = rng.standard_normal(2 * n)
            return v * np.maximum(1.0, np.abs(x0)) / np.linalg.norm(v)

        max_rel = 0.0
        for _ in range(n_dirs):
            v = direction()
            h = fd_eps
            fd = (R(x0 + h * v) - R(x0 - h * v)) / (2 * h)
            jv = J @ v
            err = np.abs(jv - fd)
            scale = max(float(np.abs(fd).max()), 1.0)
            rel = float(err.max()) / scale
            max_rel = max(max_rel, rel)
            if err.max() > abs_tol * scale + rel_tol * scale:
                i = int(err.argmax())
                raise RuntimeError(
                    f"Jacobian check failed at row {i}: "
                    f"AD(Jv)={jv[i]:.6e} FD={fd[i]:.6e} "
                    f"(abs err {err[i]:.3e}, scale {scale:.3e})")

        if seb is not None:
            # the face blocks alone, with their own scale (a face error
            # hidden under the global residual's scale would pass above)
            Jf = sp.coo_matrix(
                (face_vals, (np.concatenate([rows_f, rows_f]),
                             np.concatenate([cols_f, cols_f + n]))),
                shape=(n, 2 * n)).tocsr()

            def Rf(x):
                xt = tens(x)
                return self.seb_face_residual(
                    xt[:n], xt[n:], X_old, bc, branch, model, bprime,
                    vertices=vertices).cpu().numpy()

            def face_dir_check(v, h):
                fd = (Rf(x0 + h * v) - Rf(x0 - h * v)) / (2 * h)
                jv = Jf @ v
                err = np.abs(jv - fd)
                scale = max(float(np.abs(fd).max()), 1.0)
                return err, jv, fd, scale

            for _ in range(n_dirs):
                err, jv, fd, scale = face_dir_check(direction(), fd_eps)
                if err.max() > (abs_tol + rel_tol) * scale:
                    err2, jv2, fd2, scale2 = face_dir_check(direction(),
                                                            fd_eps / 8)
                    if err2.max() > (abs_tol + rel_tol) * scale2:
                        i = int(err2.argmax())
                        raise RuntimeError(
                            f"Jacobian check failed at face row {i} "
                            f"(branch={branch}): AD(Jv)={jv2[i]:.6e} "
                            f"FD={fd2[i]:.6e} (abs err {err2[i]:.3e}, "
                            f"scale {scale2:.3e})")
                    continue
                max_rel = max(max_rel, float(err.max()) / scale)
        return max_rel

    def advance_state_arrays(self, X_old, T, p, dt):
        """The state advance on the device: returns
        (X_new, tau_e, rho_e, pi_e, mdot_e, extent_e (nr, ne), pi_qp)."""
        ops = self.ops
        mat = self.mat
        Tq = ops.values_at_qp(T)
        pq = ops.values_at_qp(p)
        X = mat.solve_reaction_extents(Tq, dt, X_old)
        solid = mat.solid_props(Tq, pq, X, extent_old=X_old, dt=dt)
        return (X, torch.mean(solid["tau"], dim=1),
                torch.mean(solid["rho_s"], dim=1),
                torch.mean(solid["pi_total"], dim=1),
                torch.mean(solid["m_dot_g"], dim=1),
                torch.mean(X, dim=1).T, solid["pi_total"])

    def state_from_arrays(self, X, tau_e, rho_e, pi_e, mdot_e, extent_e,
                          pi_qp) -> AblationState:
        """An AblationState from ``advance_state_arrays``' output (the
        diagnostics are copied to the host)."""
        mat = self.mat

        def host(a):
            if not torch.is_tensor(a):
                return np.asarray(a)
            host_sync()
            return a.cpu().numpy()

        tau_e, rho_e = host(tau_e), host(rho_e)
        rho_v = mat.initial_solid_density()
        rho_c = mat.char_solid_density()
        den = rho_v - rho_c
        cdf = np.clip((rho_v - rho_e) / den, 0.0, 1.0) if abs(den) > 1e-14 \
            else np.zeros_like(rho_e)
        return AblationState(
            extent=X, tau_elem=tau_e, rho_elem=rho_e,
            pi_elem=host(pi_e), mdot_elem=host(mdot_e),
            extent_elem=host(extent_e),
            degree_char_elem=np.clip(1.0 - tau_e, 0.0, 1.0),
            char_density_fraction_elem=cdf, pi_qp=host(pi_qp))

    def advance_state(self, state: AblationState, T, p, dt) -> AblationState:
        """Commit per-QP extents after a converged step and refresh the
        element-average diagnostics (AdvanceInternalStates)."""
        return self.state_from_arrays(
            *self.advance_state_arrays(state.extent, T, p, dt))

    def top_boundary_mass_flux(self, T, p, state, vertices=None):
        """Area-averaged outward Darcy mass flux on the top boundary
        (ComputeTopBoundaryMassFlux), a 0-d tensor.  Uses the adjacent
        element's first-QP reaction state as representative.  ``state`` may
        be an AblationState or a raw (ne, nq, nr) extent tensor."""
        tr = self.trace
        Tq = tr.values(T)
        pq = tr.values(p)
        gp = tr.grads(p, vertices)
        extent = state.extent if isinstance(state, AblationState) else state
        Xrep = extent[self._trace_elem, 0]  # (nbf, nr)
        Xf = torch.broadcast_to(Xrep[:, None, :],
                                (tr.nbf, tr.quad.nqp, Xrep.shape[-1]))
        solid = self.mat.solid_props(Tq, pq, Xf)
        gas = self.mat.gas_props(Tq, pq)
        mu = torch.clamp(gas["mu"], min=MU_FLOOR)
        rho_darcy = gas["rho"] * solid["K"] / mu
        rho2_darcy = gas["rho"] * rho_darcy
        mflux = (-rho_darcy[..., None] * gp
                 + rho2_darcy[..., None] * self.gravity)
        ff = tr.face_factors(vertices)
        flux_int = torch.sum(torch.sum(mflux * ff.normal, dim=-1) * ff.wdS)
        area = torch.sum(ff.wdS)
        return torch.where(area > 0, flux_int / area,
                           torch.full_like(area, float("nan")))

    # -- surface energy balance (case 2.1) ---------------------------------

    def _seb_face_qp(self, Tw, pw, gpw, Xrep, normal, bc, branch, model,
                     bprime, count_clamps=False):
        """Flux terms at face QPs given trace values (batched (nbf, nqf))."""
        from .seb import surface_flux

        mat = self.mat
        Xf = torch.broadcast_to(Xrep[:, None, :],
                                Tw.shape + (Xrep.shape[-1],))
        solid = mat.solid_props(Tw, pw, Xf)
        gas = mat.gas_props(Tw, pw)
        mu = torch.clamp(gas["mu"], min=MU_FLOOR)
        rho_darcy = gas["rho"] * solid["K"] / mu
        rho2_darcy = gas["rho"] * rho_darcy
        mflux = (-rho_darcy[..., None] * gpw
                 + rho2_darcy[..., None] * self.gravity)
        m_dot_g_w = torch.sum(mflux * normal, dim=-1)
        emissivity = torch.full_like(Tw, model.emissivity_override) \
            if model.use_emissivity_override else solid["emissivity"]
        absorptivity = torch.full_like(Tw, model.absorptivity_override) \
            if model.use_absorptivity_override else solid["absorptivity"]
        terms = surface_flux(m_dot_g_w, gas["h"], Tw, emissivity,
                             absorptivity, solid["reflectivity"], bc, branch,
                             model, bprime, count_clamps=count_clamps)
        terms["m_dot_g_w"] = m_dot_g_w
        terms["rho_s"] = solid["rho_s"]
        return terms

    def _wall_grads(self, p, vertices=None):
        """(nbf, nqf, dim) wall gradients of p, contracted from each face
        element's values less its first one: a uniform p (the first Newton
        iterate) gives exactly 0, as the JAX package's contraction does,
        so the wall mass flux sits exactly on ``solve_blowing``'s
        max(raw, 0) tie there (a plain contraction leaves ~1e-12 of |p|)."""
        tr = self.trace
        p_e = p[tr.eldofs]
        gref = torch.einsum("fqnr,fn->fqr", tr.Gtab[tr._combo_t],
                            p_e - p_e[:, :1])
        return torch.sum(tr.element_invJ(vertices) * gref[..., :, None],
                         dim=-2)

    def seb_face_residual(self, T, p, extent, bc, branch, model, bprime,
                          vertices=None):
        """R_T contribution of the SEB boundary integrator:
        R_T[i] -= int q_surf psi_i ds over the top boundary."""
        tr = self.trace
        ff = tr.face_factors(vertices)
        terms = self._seb_face_qp(tr.values(T), tr.values(p),
                                  self._wall_grads(p, vertices),
                                  extent[self._trace_elem, 0], ff.normal, bc,
                                  branch, model, bprime)
        return -tr.scatter(terms["q_surf"] * ff.wdS)

    def seb_face_res_fn(self, bc, branch, model, bprime):
        """Single-face SEB residual closure ``face_res(elT, elp, B, G, iJ,
        nrm, wdS, Xr) -> rT (nd,)`` for the AD face Jacobians (the wall
        gradient as in ``_wall_grads``); ``bc``,
        ``branch``, ``model`` and ``bprime`` come from the closure.  It
        never scatters (``vmap`` refuses an in-place ``index_add_`` into an
        unbatched target)."""

        def face_res(elT, elp, B, G, iJ, nrm, wdS, Xr):
            Tw = (B @ elT)[None]
            pw = (B @ elp)[None]
            gref = torch.einsum("qnr,n->qr", G, elp - elp[0])
            gpw = torch.sum(iJ * gref[..., :, None], dim=-2)[None]
            terms = self._seb_face_qp(Tw, pw, gpw, Xr[None], nrm[None], bc,
                                      branch, model, bprime)
            return -(B.T @ (terms["q_surf"][0] * wdS))

        return face_res

    def seb_face_jacobians(self, T, p, extent, bc, branch, model, bprime,
                           vertices=None):
        """(nbf, nd, nd) x2 face Jacobian blocks d(rT_face)/d(elT, elp), all
        faces in one ``vmap(jacfwd)``.

        On a CUDA device the call is kept as a CUDA graph per key, as
        ``element_jacobians`` keeps its own: the key is the shapes, dtype
        and device, ``branch``, ``bc``'s static fields, ``model``'s fields
        and the B' table, so a branch or a table of its own captures anew.
        The graph's inputs are T, p, the face geometry of ``vertices``
        (``invJ``, ``normal``, ``wdS``: the mesh moves between calls), the
        representative extents and ``bc``'s boundary values (0-d device
        tensors: a key never holds them).  The eager call takes the same
        values as 0-d tensors, so it runs what the graph replays.  Each
        call counts ``face_jacobian_eager``, ``face_jacobian_captures`` or
        ``face_jacobian_replays`` on the timer whose span is open."""
        tr = self.trace
        ff = tr.face_factors(vertices)
        args = (T, p, tr.element_invJ(vertices), ff.normal, ff.wdS,
                extent[self._trace_elem, 0])
        values = tuple(float(getattr(bc, k)) for k in _BC_VALUES)
        static = (bc, branch, model, bprime)
        key = (tr.nbf, tr.quad.nqp, tr.eldofs.shape[1], extent.shape[-1],
               T.dtype, T.device, branch, bc.has_hconv, bc.has_Tedge,
               bc.chemistryOn, dataclasses.astuple(model), id(bprime))

        def eager():
            full = lambda v: torch.full((), v, dtype=T.dtype, device=T.device)
            return self._face_jacobians(*args, *map(full, values), *static)

        return self._by_key(
            "face_jacobian", key, eager,
            lambda: self._capture_face_jacobians(args, values, static),
            args, values)

    def _face_jacobians(self, T, p, invJ, normal, wdS, Xrep, p_w, rhoeUeCH,
                        h_r, hconv, Tedge, bc, branch, model, bprime):
        bc = dataclasses.replace(bc, p_w=p_w, rhoeUeCH=rhoeUeCH, h_r=h_r,
                                 hconv=hconv, Tedge=Tedge)
        tr = self.trace
        face_res = self.seb_face_res_fn(bc, branch, model, bprime)
        jacf = torch.func.vmap(torch.func.jacfwd(face_res, argnums=(0, 1)))
        return jacf(T[tr.eldofs], p[tr.eldofs], tr.Btab[tr._combo_t],
                    tr.Gtab[tr._combo_t], invJ, normal, wdS, Xrep)

    def _capture_face_jacobians(self, args, values, static):
        """The CUDA graph of ``_face_jacobians`` at these arguments' key
        (``_JacobianGraph``).  It keeps ``static``: the graph reads the B'
        table's device arrays, and the key holds the table's ``id``."""
        graph = _JacobianGraph(lambda *a: self._face_jacobians(*a, *static),
                               args, values)
        graph.static = static
        return graph

    _SURF_KEYS = ("m_dot_c_surf", "rho_s_surf", "BprimeG_surf",
                  "BprimeC_surf", "h_w_surf", "emissivity_surf",
                  "absorptivity_surf", "reflectivity_surf",
                  "blowing_correction_surf", "q_conv_surf",
                  "q_adv_pyro_surf", "q_rad_emit_surf", "q_rad_abs_surf",
                  "q_surf")
    _CLAMP_KEYS = ("clamps_p", "clamps_bg", "clamps_t")
    BOUNDARY_VALUE_KEYS = ("m_dot_g_surf",) + _SURF_KEYS + ("area",) \
        + _CLAMP_KEYS

    def top_boundary_terms(self, T, p, Xrep, bc, branch, model, bprime,
                           vertices=None):
        """Area-averaged surface terms: a dict of 0-d tensors on the
        device, with ``m_dot_g_surf``, ``area`` and the B'-table clamp
        counts."""
        tr = self.trace
        ff = tr.face_factors(vertices)
        terms = self._seb_face_qp(tr.values(T), tr.values(p),
                                  self._wall_grads(p, vertices), Xrep,
                                  ff.normal, bc, branch, model, bprime)
        area = torch.sum(ff.wdS)
        den = torch.clamp(area, min=1e-300)
        avg = lambda x: torch.sum(x * ff.wdS) / den
        # each *_surf key averages the term of its stem (q_surf: q_surf)
        out = {k: avg(terms[k if k == "q_surf" else k[:-len("_surf")]])
               for k in self._SURF_KEYS}
        out["m_dot_g_surf"] = avg(terms["m_dot_g_w"])
        out["area"] = area
        for k in self._CLAMP_KEYS:
            out[k] = terms[k]
        return out

    def top_boundary_values(self, T, p, extent, bc, branch, model, bprime,
                            vertices=None):
        """``top_boundary_terms`` stacked into one device vector,
        [m_dot_g_surf, *_SURF_KEYS, area, *_CLAMP_KEYS] (the scan path
        keeps a frame of them on the device and reads them back at once)."""
        vals = self.top_boundary_terms(T, p, extent[self._trace_elem, 0], bc,
                                       branch, model, bprime,
                                       vertices=vertices)
        return torch.stack([vals[k] for k in self.BOUNDARY_VALUE_KEYS])

    def boundary_diagnostics_from_values(self, vals, bprime,
                                         compute_surface_terms=True,
                                         count_clamps=True):
        """The diagnostics dict of one host row of ``top_boundary_values``;
        adds the clamp counts to ``bprime.clamp_stats``."""
        v = dict(zip(self.BOUNDARY_VALUE_KEYS, (float(x) for x in vals)))
        if count_clamps and bprime is not None:
            bprime.clamp_stats.p += int(v["clamps_p"])
            bprime.clamp_stats.bg += int(v["clamps_bg"])
            bprime.clamp_stats.t += int(v["clamps_t"])
        if v["area"] <= 0:
            return {k: float("nan") for k in
                    ("m_dot_g_surf",) + self._SURF_KEYS}
        out = {"m_dot_g_surf": v["m_dot_g_surf"]}
        for k in self._SURF_KEYS:
            out[k] = v[k] if compute_surface_terms else float("nan")
        return out

    def top_boundary_diagnostics(self, T, p, state: AblationState, bc,
                                 branch, model, bprime,
                                 compute_surface_terms=True, vertices=None,
                                 count_clamps=True):
        """Area-averaged surface diagnostics (ComputeTopBoundaryDiagnostics):
        13 quantities + m_dot_g_surf, as host floats; the values and the
        clamp counts come back in one read-back."""
        vals = self.top_boundary_values(T, p, state.extent, bc, branch,
                                        model, bprime, vertices=vertices)
        return self.boundary_diagnostics_from_values(
            vals.cpu().numpy(), bprime,
            compute_surface_terms=compute_surface_terms,
            count_clamps=count_clamps)

    # -- case 2.2 ------------------------------------------------------------

    def _recession_velocity_terms(self, T, p, Xrep, bc, branch, model,
                                  bprime, recession_density_mode,
                                  recession_density_constant, vertices):
        """The body of ``top_boundary_recession_velocity`` on the
        representative extents ``Xrep`` (nbf, nr): a tensor (n,)."""
        tr = self.trace
        Tw = tr.values(T)
        ff = tr.face_factors(vertices)
        terms = self._seb_face_qp(Tw, tr.values(p),
                                  self._wall_grads(p, vertices), Xrep,
                                  ff.normal, bc, branch, model, bprime)
        rho_rec = terms["rho_s"] if recession_density_mode == "char_surface" \
            else torch.full_like(Tw, recession_density_constant)
        zero = torch.zeros_like(Tw)
        rho_rec = torch.maximum(rho_rec, zero + 1e-8)
        v_rec = torch.maximum(zero, terms["m_dot_c"]) / rho_rec
        num = tr.scatter(v_rec * ff.wdS)
        den = tr.scatter(ff.wdS)
        tiny = torch.finfo(den.dtype).tiny
        v = torch.where(den > 1e-16,
                        num / torch.maximum(den, torch.full_like(den, tiny)),
                        0.0)
        v = torch.where(torch.isfinite(v) & (v > 0), v, 0.0)
        # restricted to the top-boundary dofs
        if not hasattr(self, "_top_mask"):
            top = np.zeros(self.n, dtype=bool)
            top[np.unique(np.asarray(tr.fes.bdr.dofs)[tr.face_ids])] = True
            self._top_mask = torch.as_tensor(top, device=v.device)
        return torch.where(self._top_mask, v, 0.0)

    def top_boundary_recession_velocity(self, T, p, state: AblationState,
                                        bc, branch, model, bprime,
                                        recession_density_mode="char_surface",
                                        recession_density_constant=1200.0,
                                        vertices=None):
        """Lumped top-boundary recession velocity (n,) at scalar DOFs, a
        tensor: v_rec = max(0, m_dot_c)/rho_rec averaged with ds psi
        weights (AssembleTopBoundaryRecessionVelocity,
        ablation_test_case2_2_2D.cpp:2740-2953), on the element QP-average
        extents as the representative state (:2454-2500)."""
        Xrep = torch.mean(state.extent, dim=1)[self._trace_elem]
        return self._recession_velocity_terms(
            T, p, Xrep, bc, branch, model, bprime, recession_density_mode,
            float(recession_density_constant), vertices)

    def _probe_columns(self, Tpt, ppt, gradp_y, Xn, pi):
        """The 9 mass-equation probe columns of points with values Tpt,
        ppt, dp/dy, extents Xn (npts, nr) and pyrolysis rate pi."""
        solid = self.mat.solid_props(Tpt, ppt, Xn)
        gas = self.mat.gas_props(Tpt, ppt)
        mu = torch.maximum(gas["mu"], torch.full_like(gas["mu"], MU_FLOOR))
        rho = gas["rho"]
        K = solid["K"]
        rho_darcy = rho * K / mu
        gy = self.gravity[1] if self.gravity.shape[0] > 1 else 0.0
        return torch.stack([
            pi, solid["tau"], solid["eps_g"] * rho, gradp_y, rho,
            gas["mu"], K, rho_darcy,
            -rho_darcy * gradp_y + rho * rho_darcy * gy], dim=1)

    def mass_eq_probe(self, T, p, state: AblationState, points,
                      vertices=None):
        """Per-point mass-equation diagnostics (SampleMassEqProbeAtPoint,
        ablation_test_case2_2_2D_test.cpp:3483-3560): for each probe point,
        [pi_total, tau, eps_g*rho_g, dp/dy, rho_g, mu_g, K,
        mobility(=rho K/mu), mflux_y] using the nearest tabulated QP's
        reaction state; NaN rows where the point is not found.  The points
        are located on the host (``core.pointlocate``); returns numpy."""
        from ..core.pointlocate import locate_points, sample_h1, \
            sample_h1_grad

        host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)
        fes = self.ops.fes
        T, p = host(T), host(p)
        vertices = None if vertices is None else host(vertices)
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        Tpt = sample_h1(fes, T, points, vertices)
        ppt = sample_h1(fes, p, points, vertices)
        gp = sample_h1_grad(fes, p, points, vertices)
        e_ids, refs = locate_points(fes.mesh, points, vertices)
        out = np.full((len(points), 9), np.nan)
        found = np.nonzero(e_ids >= 0)[0]
        if len(found) == 0:
            return out
        qp_ref = np.asarray(self.ops.quad.points)
        d2 = ((refs[found][:, None, :] - qp_ref[None]) ** 2).sum(axis=2)
        nearest_q = np.argmin(d2, axis=1)
        Xn = host(state.extent)[e_ids[found], nearest_q]  # (nf, nr)
        if state.pi_qp is not None:
            pi = np.asarray(state.pi_qp)[e_ids[found], nearest_q]
        else:
            pi = np.asarray(state.pi_elem)[e_ids[found]]
        gradp_y = gp[found][:, 1] if gp.shape[1] > 1 \
            else np.zeros(len(found))
        tens = lambda a: torch.as_tensor(np.asarray(a), dtype=self.ops.dtype,
                                         device=self.ops.device)
        out[found] = host(self._probe_columns(
            tens(Tpt[found]), tens(ppt[found]), tens(gradp_y), tens(Xn),
            tens(pi)))
        return out

    def mass_eq_probe_scan(self, T, p, X, pi_qp, sampler, loc, verts):
        """``mass_eq_probe`` on the device: the same 9 columns per point,
        fed by a ``TrackedSampler`` location ``loc = sampler.locate(verts)``
        (no read-back); NaN rows where not found."""
        eid, ref, found = loc
        Tpt = sampler.sample_h1(loc, T)
        ppt = sampler.sample_h1(loc, p)
        gp = sampler.sample_grad(loc, p, verts)
        qp_ref = torch.as_tensor(np.asarray(self.ops.quad.points),
                                 dtype=ref.dtype, device=ref.device)
        d2 = ((ref[:, None, :] - qp_ref[None]) ** 2).sum(dim=2)
        nearest_q = torch.argmin(d2, dim=1)
        e_safe = torch.clamp(eid, min=0).long()
        out = self._probe_columns(Tpt, ppt, gp[:, 1],
                                  X[e_safe, nearest_q],
                                  pi_qp[e_safe, nearest_q])
        return torch.where(found[:, None], out, float("nan"))
