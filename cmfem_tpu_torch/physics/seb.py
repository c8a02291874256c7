"""Surface energy balance: q_surf = q_conv + q_adv_pyro + q_rad_emit + q_rad_abs.

Port of ``cmfem_tpu/physics/seb.py`` (the reference's surface-flux model):

- branch classification chemistry-blowing / chemistry-no-blowing /
  cooling-standard / cooling-exact;
- blowing correction phi = ln(1 + 2 lambda B'g)/(2 lambda B'g) with a
  series below 1e-10;
- fixed-point B'g solve (3 iterations; case 2.2's coupled B'g + B'c solve,
  8 iterations);
- flux terms.

The reference's hand-linearized partials are replaced by AD through these
functions.  The branch is a per-step static value (it depends only on the
schedule time).  ``jnp.maximum``/``jnp.minimum`` become ``torch.maximum``/
``torch.minimum``, which split the derivative 0.5 / 0.5 at a tie as JAX
does: at the first Newton iterate p is uniform, so the wall mass flux is
exactly 0 and ``solve_blowing``'s ``max(raw, 0)`` sits on its tie, where
the face Jacobian equals JAX's only under the same rule.

The boundary values of a ``BoundaryState`` (``p_w``, ``rhoeUeCH``,
``h_r``, ``hconv``, ``Tedge``) may be floats or 0-d tensors on the
device, as the face-Jacobian CUDA graph passes them: the arithmetic on
them is the same either way, and with tensors nothing is read back or
copied from the host.  The constant bounds are fills on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .bprime import BPrimeTable, _const
from .surface_bc import BoundaryState

BRANCH_CHEMISTRY_BLOWING = "chemistry_blowing"
BRANCH_CHEMISTRY_NO_BLOWING = "chemistry_no_blowing"
BRANCH_COOLING_STANDARD = "cooling_standard"
BRANCH_COOLING_EXACT = "cooling_exact"


@dataclass
class SurfaceFluxModel:
    lam: float = 0.5
    q_rad: float = 0.0
    T_background: float = 300.0
    T_edge: float = 300.0
    hconv: float = 0.0
    emissivity_override: float = float("nan")
    absorptivity_override: float = float("nan")
    stefan_boltzmann: float = 5.670374419e-8
    strict_case2_1: bool = True
    strict_case2_2: bool = False
    pato_compat_mode: str = "off"  # "off" | "cooling_exact"
    case22: bool = False  # use the coupled B'g+B'c blowing solve (2.2)

    @property
    def use_emissivity_override(self) -> bool:
        return bool(np.isfinite(self.emissivity_override))

    @property
    def use_absorptivity_override(self) -> bool:
        return bool(np.isfinite(self.absorptivity_override))


def classify_branch(bc: BoundaryState, model: SurfaceFluxModel) -> str:
    if model.pato_compat_mode == "cooling_exact" and bc.chemistryOn == 0:
        return BRANCH_COOLING_EXACT
    if bc.chemistryOn:
        if max(0.0, bc.rhoeUeCH) > 1e-14:
            return BRANCH_CHEMISTRY_BLOWING
        return BRANCH_CHEMISTRY_NO_BLOWING
    return BRANCH_COOLING_STANDARD


def _max(x, c):
    return torch.maximum(x, _const(c, x))


def _floor(v, c):
    """max(v, c) of a boundary value (a float or a 0-d tensor)."""
    return torch.clamp(v, min=c) if torch.is_tensor(v) else max(float(v), c)


def _full(like, v):
    """A boundary value (a float or a 0-d tensor) in ``like``'s shape."""
    return v.expand_as(like) if torch.is_tensor(v) else \
        torch.full_like(like, v)


def blowing_correction(Bg, lam):
    """phi = ln(1 + 2 lam Bg)/(2 lam Bg), series below 1e-10."""
    lam = max(float(lam), 0.0)
    Bg_pos = _max(Bg, 0.0)
    arg = 2.0 * lam * Bg_pos
    small = arg < 1e-10
    series = 1.0 - 0.5 * arg + (1.0 / 3.0) * arg * arg
    # the safe argument keeps forward AD of log1p(arg)/arg finite at 0
    arg_safe = torch.where(small, 1.0, arg)
    full = torch.log1p(arg_safe) / arg_safe
    return torch.where(small, series, full)


def solve_blowing(m_dot_g_w, rhoeUeCH, lam, enable: bool):
    """Fixed-point B'g/phi solve, 3 iterations.

    Returns (BprimeG, phi); differentiable in m_dot_g_w through the
    unrolled iterations."""
    if not enable:
        z = torch.zeros_like(m_dot_g_w)
        return z, torch.ones_like(z)
    phi = torch.ones_like(m_dot_g_w)
    # floored: a schedule point with rhoeUeCH == 0 reaching the blowing
    # branch must not produce inf -> NaN(phi)
    rhoeUeCH_eff = _floor(rhoeUeCH, 1e-12)
    for _ in range(3):
        raw = m_dot_g_w / (rhoeUeCH_eff * _max(phi, 1e-12))
        Bg = _max(raw, 0.0)
        phi = blowing_correction(Bg, lam)
    return Bg, phi


def solve_blowing_22(m_dot_g_w, rhoeUeCH, p_w, T_w, bprime: BPrimeTable,
                     chemistry_on: bool, strict: bool, lam, enable: bool,
                     return_lut: bool = False):
    """Case-2.2 coupled fixed point: the blowing correction uses the TOTAL
    B' = B'g + B'c with B'c looked up inside the loop (8 iterations).
    Returns (BprimeG, BprimeC, phi); with ``return_lut``, also the final
    in-loop B' lookup dict (or None when the loop did no lookups), which
    is evaluated at the converged (p_w, B'g, T_w)."""
    z = torch.zeros_like(m_dot_g_w)
    lut = None
    if not enable:
        out = (z, z, torch.ones_like(z))
        return out + (lut,) if return_lut else out
    rhoeUeCH_eff = _floor(rhoeUeCH, 1e-12)
    Bc = z
    phi = torch.ones_like(z)
    for _ in range(8):
        Bg = _max(m_dot_g_w / (rhoeUeCH_eff * _max(phi, 1e-12)), 0.0)
        if chemistry_on and not strict:
            lut = bprime.lookup(_full(Bg, p_w), Bg, T_w)
            Bc = lut["bc"]
        else:
            Bc = z
        phi = blowing_correction(Bg + Bc, lam)
    out = (Bg, Bc, phi)
    return out + (lut,) if return_lut else out


def surface_flux(m_dot_g_w, h_g, T_w, emissivity, absorptivity, reflectivity,
                 bc: BoundaryState, branch: str, model: SurfaceFluxModel,
                 bprime: Optional[BPrimeTable], count_clamps: bool = False):
    """Flux terms at face QPs; all inputs batched tensors except bc/
    branch/model (static per step).  Returns a dict of terms including
    q_surf (positive = heating into the solid)."""
    sigma = model.stefan_boltzmann
    T_bg4 = model.T_background ** 4
    hconv_eff = bc.hconv if bc.has_hconv else model.hconv
    Tedge_eff = bc.Tedge if bc.has_Tedge else model.T_edge

    zeros = torch.zeros_like(T_w)
    scalar0 = T_w.new_zeros(())
    out = {
        "emissivity": emissivity, "absorptivity": absorptivity,
        "reflectivity": reflectivity,
        "BprimeG": zeros, "BprimeC": zeros, "h_w": zeros,
        "blowing_correction": torch.ones_like(zeros),
        "q_adv_char": zeros, "m_dot_c": zeros,
        "clamps_p": scalar0, "clamps_bg": scalar0, "clamps_t": scalar0,
    }
    q_rad_emit = -emissivity * sigma * (T_w ** 4 - T_bg4)
    q_rad_abs = absorptivity * model.q_rad

    if branch == BRANCH_COOLING_EXACT:
        out["q_conv"] = hconv_eff * (Tedge_eff - T_w)
        out["q_adv_pyro"] = -m_dot_g_w * h_g
        out["q_rad_emit"] = q_rad_emit
        out["q_rad_abs"] = q_rad_abs
        out["q_surf"] = (out["q_conv"] + out["q_adv_pyro"] + out["q_adv_char"]
                         + q_rad_emit + q_rad_abs)
        return out

    chemistry_on = bc.chemistryOn != 0
    rhoeUeCH = _floor(bc.rhoeUeCH, 0.0)
    blowing_active = branch == BRANCH_CHEMISTRY_BLOWING
    if model.case22:
        Bg, _, phi, lut22 = solve_blowing_22(
            m_dot_g_w, rhoeUeCH, bc.p_w, T_w, bprime, chemistry_on,
            model.strict_case2_2, model.lam, blowing_active,
            return_lut=True)
    else:
        Bg, phi = solve_blowing(m_dot_g_w, rhoeUeCH, model.lam,
                                blowing_active)
        lut22 = None

    if bprime is not None:
        if lut22 is not None and not count_clamps:
            # the fixed point's final lookup is already at the converged
            # (p_w, B'g, T_w): reuse it instead of a 9th table pass
            lut = lut22
        else:
            lut = bprime.lookup(_full(zeros, bc.p_w), Bg, T_w,
                                count_clamps=count_clamps)
        h_w = lut["hw"] if chemistry_on else zeros
        bc_val = lut["bc"]
        count = lambda m: torch.sum(m.to(T_w.dtype))
        out["clamps_p"] = count(lut["clamped_p"])
        out["clamps_bg"] = count(lut["clamped_bg"])
        out["clamps_t"] = count(lut["clamped_t"])
    else:
        h_w = zeros
        bc_val = zeros

    strict = model.strict_case2_2 if model.case22 else model.strict_case2_1
    out["BprimeG"] = Bg
    out["BprimeC"] = bc_val if (chemistry_on and not strict) else zeros
    out["h_w"] = h_w
    out["blowing_correction"] = phi
    # char consumption rate (2.2): m_dot_c = rhoeUeCH * B'c * phi
    out["m_dot_c"] = (rhoeUeCH * out["BprimeC"] * phi) if chemistry_on \
        else zeros
    out["q_rad_emit"] = q_rad_emit
    out["q_rad_abs"] = q_rad_abs
    out["q_adv_pyro"] = -m_dot_g_w * h_w
    if chemistry_on:
        out["q_conv"] = rhoeUeCH * phi * (bc.h_r - h_w)
    else:
        out["q_conv"] = hconv_eff * (Tedge_eff - T_w)
    out["q_surf"] = (out["q_conv"] + out["q_adv_pyro"] + out["q_adv_char"]
                     + q_rad_emit + q_rad_abs)
    return out
