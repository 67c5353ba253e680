"""Constitutive relations for the EVP velocity solver.

Pointwise stress updates at cell corners, matching the behavior of the
reference (`mpas_seaice_velocity_solver_constitutive_relation.F:178-373`):
standard EVP (Hunke-style with replacement pressure), revised EVP
(Bouillon et al. 2013) and the linear test relation. All functions are
shape-polymorphic tensor ops.
"""

import torch

from .. import constants as c


def _delta(e11, e22, e12):
    div = e11 + e22
    tension = e11 - e22
    shearing = 2.0 * e12
    delta = torch.sqrt(div * div +
                       (tension * tension + shearing * shearing)
                       / c.EVP_ECCENTRICITY_SQ)
    return div, tension, shearing, delta


def evp_stress_update(s11, s22, s12, e11, e22, e12, pressure,
                      dt_elastic: float, damping_timescale: float):
    """Standard EVP semi-implicit stress relaxation.

    pressure broadcasts over the corner axis ([nCells, 1] against
    [nCells, maxEdges] corner arrays).
    Returns (s11, s22, s12, replacement_pressure).
    """
    div, tension, shearing, delta = _delta(e11, e22, e12)

    stress1 = s11 + s22
    stress2 = s11 - s22

    p_coeff = pressure / delta.clamp(min=c.PUNY)
    replacement_pressure = p_coeff * delta
    p_coeff = (p_coeff * dt_elastic) / (2.0 * damping_timescale)

    denom = 1.0 + (0.5 * dt_elastic) / damping_timescale

    stress1 = (stress1 + p_coeff * (div - delta)) / denom
    stress2 = (stress2 + (p_coeff / c.EVP_ECCENTRICITY_SQ) * tension) / denom
    s12 = (s12 + (p_coeff / c.EVP_ECCENTRICITY_SQ) * shearing * 0.5) / denom

    s11 = 0.5 * (stress1 + stress2)
    s22 = 0.5 * (stress1 - stress2)
    return s11, s22, s12, replacement_pressure


def evp_stress_update_revised(s11, s22, s12, e11, e22, e12, pressure):
    """Revised EVP (Bouillon et al. 2013) stress relaxation
    (reference :262-330)."""
    div, tension, shearing, delta = _delta(e11, e22, e12)

    stress1 = s11 + s22
    stress2 = s11 - s22

    p_coeff = pressure / delta.clamp(min=c.PUNY)
    replacement_pressure = p_coeff * delta
    p_coeff = (p_coeff * 2.0 * c.REVISED_EVP_DAMPING_RATIO
               / c.REVISED_EVP_DAMPING_RATIO_DENOM)

    denom = 1.0 + (2.0 * c.REVISED_EVP_DAMPING_RATIO
                   / c.REVISED_EVP_DAMPING_RATIO_DENOM)

    stress1 = (stress1 + p_coeff * (div - delta)) / denom
    stress2 = (stress2 + (p_coeff / c.EVP_ECCENTRICITY_SQ) * tension) / denom
    s12 = (s12 + (p_coeff / c.EVP_ECCENTRICITY_SQ) * shearing * 0.5) / denom

    s11 = 0.5 * (stress1 + stress2)
    s22 = 0.5 * (stress1 - stress2)
    return s11, s22, s12, replacement_pressure


def linear_stress(e11, e22, e12, lam: float = 1.0):
    """Linear (test) constitutive relation (reference :344-373)."""
    return lam * e11, lam * e22, lam * e12
