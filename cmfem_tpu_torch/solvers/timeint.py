"""Diagonally-implicit Runge-Kutta (DIRK) time integration.

Port of ``cmfem_tpu/solvers/timeint.py``: backward Euler and the classical
stiffly-accurate, L-stable SDIRK schemes of orders 2 and 3 (Alexander
1977).  Every stage of an SDIRK scheme shares the single diagonal
coefficient gamma, so all stage solves go through ONE operator
M + gamma*dt*K with no re-assembly.

For the semi-discrete linear system

    M du/dt + K u = f(t),      u = g(t) on the essential dofs,

stage i solves

    (M + gamma*dt*K) y_i = M s_i + gamma*dt*f(t_n + c_i*dt),
    y_i = g(t_n + c_i*dt) at the essential dofs,

with the accumulated predictor s_i = u_n + dt*sum_{j<i} a_ij k_j and
the stage derivative k_i = (y_i - s_i) / (gamma*dt).  Stiffly-accurate
tableaus (b == last row of A) finish with u_{n+1} = y_s, so the step
lands exactly on the boundary schedule at t_{n+1}.  The tableaux are the
JAX package's; the step is a plain function on tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class DIRKTableau:
    """Butcher tableau of a DIRK scheme with constant diagonal gamma."""

    name: str
    A: tuple  # (s, s) lower-triangular rows, a_ii == gamma
    b: tuple  # (s,)
    c: tuple  # (s,)
    order: int

    @property
    def stages(self) -> int:
        return len(self.b)

    @property
    def gamma(self) -> float:
        return self.A[0][0]

    @property
    def stiffly_accurate(self) -> bool:
        return all(abs(self.A[-1][j] - self.b[j]) < 1e-14
                   for j in range(self.stages))


def _sdirk2() -> DIRKTableau:
    # Alexander's 2-stage, order-2, L-stable, stiffly accurate tableau
    g = 1.0 - 1.0 / np.sqrt(2.0)
    return DIRKTableau("sdirk2",
                       A=((g, 0.0), (1.0 - g, g)),
                       b=(1.0 - g, g),
                       c=(g, 1.0),
                       order=2)


def _sdirk3() -> DIRKTableau:
    # Alexander's 3-stage, order-3, L-stable, stiffly accurate tableau:
    # gamma is the root of x^3 - 3x^2 + (3/2)x - 1/6 in (1/6, 1/2)
    g = 0.43586652150845899942
    c2 = 0.5 * (1.0 + g)
    b1 = -0.25 * (6.0 * g * g - 16.0 * g + 1.0)
    b2 = 0.25 * (6.0 * g * g - 20.0 * g + 5.0)
    return DIRKTableau("sdirk3",
                       A=((g, 0.0, 0.0),
                          (c2 - g, g, 0.0),
                          (b1, b2, g)),
                       b=(b1, b2, g),
                       c=(g, c2, 1.0),
                       order=3)


_TABLEAUS = {
    "be": DIRKTableau("be", A=((1.0,),), b=(1.0,), c=(1.0,), order=1),
    "backward_euler": DIRKTableau("be", A=((1.0,),), b=(1.0,), c=(1.0,),
                                  order=1),
    "sdirk2": _sdirk2(),
    "sdirk3": _sdirk3(),
}


def get_tableau(name: str) -> DIRKTableau:
    key = str(name).strip().lower()
    if key not in _TABLEAUS:
        raise ValueError(f"unknown time integrator {name!r}; "
                         f"choose from {sorted(set(_TABLEAUS))}")
    return _TABLEAUS[key]


def make_linear_dirk_step(tab: DIRKTableau, dt: float,
                          apply_M: Callable, apply_stage: Callable,
                          bc, solve: Callable):
    """Build ``step(u, f_stages, g_stages) -> (u_next, iters)``.

    ``apply_M`` applies the mass operator; ``apply_stage`` applies the
    stage operator M + gamma*dt*K, which the caller should assemble as
    ONE combined form (mass + gamma*dt-scaled stiffness) so each stage
    solve streams a single fused operator — the same trick the
    reference uses for its BE LHS (``diffusion_mms.cpp:301-305``).
    ``bc`` is an :class:`~cmfem_tpu_torch.ops.bc.EssentialBC`;
    ``solve(op, B, x0)`` performs the constrained linear solve and
    returns an object with ``.x`` and ``.iters`` (e.g. a bound
    ``cg``/``gmres`` closure).  ``f_stages`` has shape (s, n) with the
    forcing at each stage time; ``g_stages`` has shape (s, n_ess) with
    the essential-dof values at each stage time.

    ``gdot_stages`` (optional, same shape as ``g_stages``): time
    derivative of the boundary data at the stage times.  Imposing
    g(t_n + c_i dt) directly at the stages costs higher-order schemes
    accuracy — the classical RK order reduction for initial-boundary
    value problems: SDIRK stage order is 1, so the boundary layer
    converges at O(dt^2) regardless of the tableau order.  With the
    derivative supplied, stage boundary values are built
    derivative-consistently as u|_ess + dt*sum_{j<=i} a_ij gdot_j, the
    essential dofs integrate the boundary schedule with the full RK
    quadrature, and the tableau order is recovered.  The returned step
    is a plain function; ``iters`` is the sum of the solves' ``.iters``.
    """
    gdt = tab.gamma * dt
    s = tab.stages

    op_c = bc.constrain_operator(apply_stage)

    def step(u, f_stages, g_stages, gdot_stages=None):
        ks = []
        y = u
        iters = 0
        g_ess = u[bc.ess_dofs]
        for i in range(s):
            s_i = u
            for j in range(i):
                aij = tab.A[i][j]
                if aij != 0.0:
                    s_i = s_i + (dt * aij) * ks[j]
            rhs = apply_M(s_i)
            if f_stages is not None:   # None = homogeneous (f == 0)
                rhs = rhs + gdt * f_stages[i]
            if gdot_stages is None:
                g_i = g_stages[i]
            else:
                g_i = g_ess
                for j in range(i + 1):
                    aij = tab.A[i][j]
                    if aij != 0.0:
                        g_i = g_i + (dt * aij) * gdot_stages[j]
            u_bc = torch.zeros_like(u).index_copy_(0, bc.ess_dofs, g_i)
            B = bc.constrained_rhs(apply_stage, rhs, u_bc)
            res = solve(op_c, B, s_i)
            y = res.x
            ks.append((y - s_i) / gdt)
            iters = iters + res.iters
        if tab.stiffly_accurate:
            u_next = y
        else:
            u_next = u
            for i in range(s):
                u_next = u_next + (dt * tab.b[i]) * ks[i]
        return u_next, iters

    return step


def stage_times(tab: DIRKTableau, t_prev: float, dt: float) -> list:
    """Physical times of the tableau stages within [t_prev, t_prev+dt]."""
    return [t_prev + ci * dt for ci in tab.c]
