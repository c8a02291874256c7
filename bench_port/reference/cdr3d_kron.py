"""Plain reference of the 3D CDR step on the unit-cube hex lattice.

On a uniform lattice of n^3 hexes of order p with constant coefficients the
assembled operator of ``mass + dt conv(beta) + kd dt diff`` is a sum of
Kronecker products of 1D matrices: with M, K and C the 1D mass, stiffness
and convection matrices (C[i, j] = int phi_j' phi_i, the trial function
differentiated),

    A = Mz My Mx + dt (bx Mz My Cx + by Mz Cy Mx + bz Cz My Mx)
        + kd dt (Mz My Kx + Mz Ky Mx + Kz My Mx).

The 1D matrices are built here in numpy from the Lagrange basis on the
Gauss-Lobatto nodes (the lattice's node positions) and a Gauss rule exact
for their integrands, and applied to a vector numbered as the lattice (x
fastest, z slowest).  Walls carry
homogeneous Dirichlet conditions: the constrained operator is the identity
on wall rows and A on the interior with wall values zeroed.  Nothing of the
program is used: the operator, its diagonal and the walls are worked out
again from the configuration.
"""

from __future__ import annotations

import numpy as np
import torch


def gll_nodes(p):
    """The p + 1 Gauss-Lobatto-Legendre nodes on [0, 1] (equispaced up to
    p = 2)."""
    inner = np.polynomial.legendre.Legendre.basis(p).deriv().roots()
    return 0.5 * (np.concatenate([[-1.0], np.sort(inner.real), [1.0]]) + 1.0)


def _lagrange_1d(p, x):
    """(values, derivatives) of the p + 1 Lagrange polynomials on the GLL
    nodes of [0, 1] at points x, each (len(x), p + 1)."""
    nodes = gll_nodes(p)
    V = np.ones((len(x), p + 1))
    dV = np.zeros((len(x), p + 1))
    for i in range(p + 1):
        others = [m for m in range(p + 1) if m != i]
        den = np.prod([nodes[i] - nodes[m] for m in others])
        for k, xk in enumerate(x):
            V[k, i] = np.prod([xk - nodes[m] for m in others]) / den
            dV[k, i] = sum(np.prod([xk - nodes[m] for m in others if m != j])
                           for j in others) / den
    return V, dV


def matrices_1d(n, p):
    """(M, K, C): the assembled 1D mass, stiffness and convection matrices
    of n elements of order p on [0, 1], each (n p + 1, n p + 1)."""
    x, w = np.polynomial.legendre.leggauss(p + 2)  # exact to degree 2p + 3
    x, w = 0.5 * (x + 1.0), 0.5 * w
    V, dV = _lagrange_1d(p, x)
    h = 1.0 / n
    Me = h * np.einsum("q,qi,qj->ij", w, V, V)
    Ke = np.einsum("q,qi,qj->ij", w, dV, dV) / h
    Ce = np.einsum("q,qi,qj->ij", w, V, dV)  # test i value, trial j slope
    N = n * p + 1
    M, K, C = (np.zeros((N, N)) for _ in range(3))
    for e in range(n):
        s = slice(e * p, e * p + p + 1)
        M[s, s] += Me
        K[s, s] += Ke
        C[s, s] += Ce
    return M, K, C


class CdrOperator:
    """The constrained CDR operator of a configuration at n^3 elements, in
    ``dtype`` on ``device``."""

    def __init__(self, config, n, device, dtype=torch.float64):
        p = int(config["order"])
        dt = float(config["dt"])
        beta = [float(b) for b in config["beta"]]
        kd = float(config["diffusion"])
        M, K, C = matrices_1d(n, p)
        self.N = N = n * p + 1
        self.dtype, self.device = dtype, device
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.M, self.K, self.C = t(M), t(K), t(C)
        # the terms of A as (coefficient, Az, Ay, Ax)
        self.terms = [(1.0, M, M, M),
                      (dt * beta[0], M, M, C), (dt * beta[1], M, C, M),
                      (dt * beta[2], C, M, M),
                      (kd * dt, M, M, K), (kd * dt, M, K, M),
                      (kd * dt, K, M, M)]
        self._mats = [(c, t(az), t(ay), t(ax)) for c, az, ay, ax in self.terms]
        i = np.arange(N)
        wall1 = (i == 0) | (i == N - 1)
        wall = (wall1[:, None, None] | wall1[None, :, None]
                | wall1[None, None, :])
        self.wall = torch.as_tensor(wall.reshape(-1), device=device)
        diag = sum(c * np.einsum("i,j,k->ijk", np.diag(az), np.diag(ay),
                                 np.diag(ax))
                   for c, az, ay, ax in self.terms).reshape(-1)
        self.diag = torch.where(self.wall, 1.0, t(diag))

    def apply(self, u):
        """A u with no walls (the operator as an apply binds it)."""
        N = self.N
        u3 = u.to(self.dtype).reshape(N, N, N)
        y = torch.zeros_like(u3)
        for c, az, ay, ax in self._mats:
            v = torch.einsum("ax,zyx->zya", ax, u3)
            v = torch.einsum("by,zya->zba", ay, v)
            y = y + c * torch.einsum("cz,zba->cba", az, v)
        return y.reshape(-1)

    def apply_constrained(self, u):
        u = u.to(self.dtype)
        return torch.where(self.wall, u,
                           self.apply(torch.where(self.wall, 0.0, u)))

    def rhs(self, u_old):
        """The BE right-hand side of a step from u_old: u_old off the walls,
        zero on them (the form's mass is in A)."""
        return torch.where(self.wall, 0.0, u_old.to(self.dtype))

    def step_residual(self, u_old, x):
        """max |D^-1 (b - A x)| / max |D^-1 b| of a step's answer x from
        u_old, with D the Jacobi diagonal (the largest entry, so that a
        few wrong entries among a million show)."""
        b = self.rhs(u_old)
        r = (b - self.apply_constrained(x)) / self.diag
        return float(r.abs().max() / (b / self.diag).abs().max())

    def solve(self, u_old, rtol=1e-6, restart=30, maxiter=20):
        """The step by Jacobi-preconditioned GMRES(restart) in this
        operator's dtype, from x0 = u_old: plain, classical Gram-Schmidt
        twice, explicit residual at each restart."""
        b = self.rhs(u_old)
        Minv = 1.0 / self.diag
        A = lambda v: Minv * self.apply_constrained(v)
        Mb = Minv * b
        tol = rtol * float(torch.linalg.vector_norm(Mb))
        x = u_old.to(self.dtype).clone()
        for _ in range(maxiter):
            r = Mb - A(x)
            beta = float(torch.linalg.vector_norm(r))
            if not beta > tol:
                break
            V = [r / beta]
            H = np.zeros((restart + 1, restart))
            for j in range(restart):
                w = A(V[j])
                for _pass in range(2):
                    Vm = torch.stack(V)
                    h = Vm @ w
                    w = w - Vm.T @ h
                    H[:j + 1, j] += h.double().cpu().numpy()
                H[j + 1, j] = float(torch.linalg.vector_norm(w))
                e1 = np.zeros(j + 2)
                e1[0] = beta
                y = np.linalg.lstsq(H[:j + 2, :j + 1], e1, rcond=None)[0]
                if (H[j + 1, j] == 0.0
                        or np.linalg.norm(H[:j + 2, :j + 1] @ y - e1) <= tol):
                    break
                V.append(w / H[j + 1, j])
            upd = torch.stack(V[:len(y)]).T @ torch.as_tensor(
                y, dtype=self.dtype, device=self.device)
            x = x + upd
        return x
