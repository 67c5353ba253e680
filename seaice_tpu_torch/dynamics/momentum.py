"""The vertex side of one elastic subcycle in plain PyTorch: ocean drag
and the 2x2 implicit momentum solve.

`momentum_update` (quadratic drag, standard EVP) is shared by the plain
versions of the subcycle-loop kernels and by the per-subcycle panel
route, whose vertex side runs in torch.  `ocean_stress_coefficient`,
`solve_velocity_evp` and `solve_velocity_revised_evp` are the JAX
package's pieces for the solver variants (any ocean stress, revised EVP),
whose subcycle loop is plain torch (`evp.variant_subcycles`)."""

import torch

from .. import constants as c


def momentum_update(u, v, div_u, div_v, uo_v, vo_v, mass_vertex, mass_f,
                    rhs_u0, rhs_v0, ocean_u, ocean_v, solve_velocity,
                    area_vertex, dte: float):
    """New (u, v) [nVertices] from the stress divergence; rhs_u0 = air
    stress + surface tilt.  Vertices with solve_velocity == 0 keep their
    values."""
    sv = solve_velocity > 0
    sgn = torch.sign(mass_f)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    # quadratic ocean drag (reference velocity_solver.F:2986-3082)
    oc = (c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER) * area_vertex * \
        torch.sqrt((uo_v - u) ** 2 + (vo_v - v) ** 2)
    oc = torch.where(sv, oc, torch.zeros_like(u))
    # 2x2 implicit point solve (reference velocity_solver.F:3096-3208)
    a11 = mass_vertex / dte + oc * c.COS_OCEAN_TURNING_ANGLE
    a12 = -mass_f - oc * c.SIN_OCEAN_TURNING_ANGLE * sgn
    a21 = mass_f + oc * c.SIN_OCEAN_TURNING_ANGLE * sgn
    rhs1 = div_u + rhs_u0 + oc * ocean_u + mass_vertex * u / dte
    rhs2 = div_v + rhs_v0 + oc * ocean_v + mass_vertex * v / dte
    det = a11 * a11 - a12 * a21
    det = torch.where(det == 0, torch.ones_like(det), det)
    u_new = (a11 * rhs1 - a12 * rhs2) / det
    v_new = (a11 * rhs2 - a21 * rhs1) / det
    return torch.where(sv, u_new, u), torch.where(sv, v_new, v)


def ocean_stress_coefficient(use_ocean_stress: bool, quadratic: bool, u, v,
                             uo_v, vo_v, area_vertex, solve_velocity):
    """Ocean drag coefficient at the vertices: quadratic, linear, or none
    (reference velocity_solver.F:2986-3082)."""
    if not use_ocean_stress:
        return torch.zeros_like(u)
    if quadratic:
        coeff = (c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER * area_vertex *
                 torch.sqrt((uo_v - u) ** 2 + (vo_v - v) ** 2))
    else:
        coeff = c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER * area_vertex
    return torch.where(solve_velocity > 0, coeff, torch.zeros_like(coeff))


def _point_solve(u, v, a11, a12, a21, rhs1, rhs2, solve_velocity):
    a22 = a11
    det = a11 * a22 - a12 * a21
    det = torch.where(det == 0, torch.ones_like(det), det)
    u_new = (a22 * rhs1 - a12 * rhs2) / det
    v_new = (a11 * rhs2 - a21 * rhs1) / det
    sv = solve_velocity > 0
    return torch.where(sv, u_new, u), torch.where(sv, v_new, v)


def _sign_or_one(x):
    sgn = torch.sign(x)
    return torch.where(sgn == 0, torch.ones_like(sgn), sgn)


def solve_velocity_evp(u, v, mass_vertex, mass_f, div_u, div_v, air_u, air_v,
                       tilt_u, tilt_v, ocean_u, ocean_v, ocean_coeff,
                       solve_velocity, dt_e: float):
    """2x2 implicit point solve (reference velocity_solver.F:3096-3208)."""
    sgn = _sign_or_one(mass_f)
    a11 = mass_vertex / dt_e + ocean_coeff * c.COS_OCEAN_TURNING_ANGLE
    a12 = -mass_f - ocean_coeff * c.SIN_OCEAN_TURNING_ANGLE * sgn
    a21 = mass_f + ocean_coeff * c.SIN_OCEAN_TURNING_ANGLE * sgn
    rhs1 = div_u + air_u + tilt_u + ocean_coeff * ocean_u + \
        mass_vertex * u / dt_e
    rhs2 = div_v + air_v + tilt_v + ocean_coeff * ocean_v + \
        mass_vertex * v / dt_e
    return _point_solve(u, v, a11, a12, a21, rhs1, rhs2, solve_velocity)


def solve_velocity_revised_evp(u, v, u_init, v_init, mass_vertex, mass_f,
                               div_u, div_v, air_u, air_v, tilt_u, tilt_v,
                               ocean_u, ocean_v, ocean_coeff, solve_velocity,
                               brlx: float, dt_dyn: float):
    """Revised-EVP point solve (reference velocity_solver.F:3222-3358):
    the inertia of the numerical relaxation brlx, against the velocity at
    the start of the solve, over the dynamics timestep."""
    sgn = _sign_or_one(mass_f)
    a11 = (brlx + 1.0) * mass_vertex / dt_dyn + \
        ocean_coeff * c.COS_OCEAN_TURNING_ANGLE
    a12 = -mass_f - ocean_coeff * c.SIN_OCEAN_TURNING_ANGLE * sgn
    a21 = -a12
    rhs1 = div_u + air_u + tilt_u + ocean_coeff * ocean_u + \
        mass_vertex * (brlx * u + u_init) / dt_dyn
    rhs2 = div_v + air_v + tilt_v + ocean_coeff * ocean_v + \
        mass_vertex * (brlx * v + v_init) / dt_dyn
    return _point_solve(u, v, a11, a12, a21, rhs1, rhs2, solve_velocity)
