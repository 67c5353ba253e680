"""The reference's dynamics with the column on: the EVP velocity solve
under Rothrock's (1975) strength from the thickness distribution
(`column_itd.rothrock_strength`), the ridging rates of the new
velocities, and the incremental remapping of the column's tracer tree
(`column.TREE`).  A phase of `model.Reference`.

The velocity solve is `velocity.solve`'s, step for step, with the
strength given instead of Hibler's; the remap is `transport.py`'s own
code, loaded a second time with the column's tree and with flux moments
to degree 4 (a pond tracer's product with its chain of parents is a
polynomial of degree 4), so the dynamical core's phase is untouched."""

from __future__ import annotations

import functools
import importlib.util

import torch

from . import column, column_itd, transport, velocity
from .velocity import (AIR_DRAG, DAMPING, DENSITY_ICE, DENSITY_SEAWATER,
                       DENSITY_SNOW, ECCENTRICITY_SQ, ICE_AREA_MINIMUM,
                       ICE_MASS_MINIMUM, ICE_OCEAN_DRAG, PUNY)

CLAIMS = ("velocity", "advection")
VELOCITY = ("u_velocity", "v_velocity", "stress11", "stress22", "stress12",
            "solve_velocity_prev")


def column_transport():
    """`transport.py` loaded anew with the column's tree."""
    spec = importlib.util.spec_from_file_location(
        f"{__package__}._column_transport", transport.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.TREE = column.TREE
    mod.HAS_CHILD = {p for _, p, _ in column.TREE if p}
    mod.polygon_moments = functools.partial(transport.polygon_moments, deg=4)
    return mod


def check_config(conf: dict):
    column.check_column(conf)
    want = {("velocity", "strain_scheme"): "VARIATIONAL",
            ("velocity", "variational_basis"): "WACHSPRESS",
            ("velocity", "include_metric_terms"): True,
            ("velocity", "rotate_cartesian_grid"): True,
            ("advection", "advection_type"): "INCREMENTAL_REMAP"}
    for keys, value in want.items():
        got = conf
        for k in keys:
            got = got.get(k) if isinstance(got, dict) else None
        if got != value:
            raise NotImplementedError(
                f"the reference implements {'.'.join(keys)} = {value!r}, "
                f"not {got!r}")


def build(ref, conf: dict):
    ref.n_sub = int(conf["velocity"]["elastic_subcycle_number"])
    ref.vgeo = velocity.VelocityGeometry(ref.mesh, ref.dtype, ref.device)
    ref.tgeo = transport.RemapGeometry(ref.mesh, ref.dtype, ref.device)
    ref.column_transport = column_transport()
    ref.ridge_rates = None


def solve(geo, vel, area, volume, snow, wind, dt, n_sub, strength):
    """`velocity.solve` with the ice strength `strength` [nc] (N m-1)
    where it takes Hibler's.  Returns the new vel dict and the cells
    where the stress is solved."""
    a = area.sum(1)
    mass = volume.sum(1) * DENSITY_ICE + snow.sum(1) * DENSITY_SNOW
    ice = ((a > ICE_AREA_MINIMUM) & (mass > ICE_MASS_MINIMUM)).to(a.dtype)
    nb = (ice[geo.cells_on_cell] * geo.coc_ok).amax(1)
    solve_stress = torch.maximum(ice, nb) > 0
    a_v = geo.to_vertex(a)
    m_v = geo.to_vertex(mass)
    sv = (a_v > ICE_AREA_MINIMUM) & (m_v > ICE_MASS_MINIMUM)
    zero = torch.zeros_like(a_v)
    new = sv & (vel["solve_velocity_prev"] == 0)
    u = torch.where(sv & ~new, vel["u_velocity"], zero)
    v = torch.where(sv & ~new, vel["v_velocity"], zero)
    pressure = torch.where(solve_stress, strength,
                           torch.zeros_like(a))[:, None]
    uw, vw, rho = wind
    speed = torch.sqrt(uw * uw + vw * vw)
    tau = rho * speed * AIR_DRAG * a
    tau_u, tau_v = geo.to_vertex(tau * uw), geo.to_vertex(tau * vw)
    mf = m_v * geo.f
    ss = solve_stress[:, None]
    s11, s22, s12 = (torch.where(ss, vel[k], torch.zeros_like(vel[k]))
                     for k in ("stress11", "stress22", "stress12"))
    dte = dt / n_sub
    T = DAMPING * dt
    denom = 1.0 + 0.5 * dte / T
    tl_c = geo.corners(geo.tan_lat)

    def at_vertex(ints, s):
        per = torch.einsum("cs,csg->cg", s, ints)
        return per[geo.cov, geo.cov_corner].sum(1)

    for _ in range(n_sub):
        div, ten, shr, delta = strain(geo, u, v, tl_c)
        c = pressure / delta.clamp(min=PUNY) * dte / (2.0 * T)
        sig1 = (s11 + s22 + c * (div - delta)) / denom
        sig2 = (s11 - s22 + c / ECCENTRICITY_SQ * ten) / denom
        n12 = (s12 + c / ECCENTRICITY_SQ * 0.5 * shr) / denom
        s11 = torch.where(ss, 0.5 * (sig1 + sig2), s11)
        s22 = torch.where(ss, 0.5 * (sig1 - sig2), s22)
        s12 = torch.where(ss, n12, s12)
        fu = -(at_vertex(geo.su, s11) + at_vertex(geo.sv, s12) +
               geo.tan_lat * at_vertex(geo.sm, s12))
        fv = -(at_vertex(geo.sv, s22) + at_vertex(geo.su, s12)) + \
            geo.tan_lat * at_vertex(geo.sm, s11)
        fu = fu / geo.area_triangle
        fv = fv / geo.area_triangle
        drag = ICE_OCEAN_DRAG * DENSITY_SEAWATER * a_v * \
            torch.sqrt(u * u + v * v)
        a11 = m_v / dte + drag
        ru = fu + tau_u + m_v * u / dte
        rv = fv + tau_v + m_v * v / dte
        d = a11 * a11 + mf * mf
        d = torch.where(d == 0, torch.ones_like(d), d)
        u = torch.where(sv, (a11 * ru + mf * rv) / d, u)
        v = torch.where(sv, (a11 * rv - mf * ru) / d, v)
    return ({"u_velocity": u, "v_velocity": v, "stress11": s11,
             "stress22": s22, "stress12": s12,
             "solve_velocity_prev": sv.to(u.dtype)}, solve_stress)


def strain(geo, u, v, tl_c):
    """(divergence, tension, shear, delta) at every corner [nc, me]."""
    uc, vc = geo.corners(u), geo.corners(v)
    e11 = torch.einsum("cb,cbg->cg", uc, geo.gx) - vc * tl_c
    e22 = torch.einsum("cb,cbg->cg", vc, geo.gy)
    e12 = 0.5 * (torch.einsum("cb,cbg->cg", uc, geo.gy) +
                 torch.einsum("cb,cbg->cg", vc, geo.gx) + uc * tl_c)
    div, ten, shr = e11 + e22, e11 - e22, 2.0 * e12
    delta = torch.sqrt(div * div + (ten * ten + shr * shr) / ECCENTRICITY_SQ)
    return div, ten, shr, delta


def ridge_rates(geo, u, v, solve_stress):
    """(convergence, shear) [nc] (1/s) that drive ridging: minus the
    negative part of the cell's mean divergence over its corners, and half
    the mean deformation rate less the divergence's magnitude (MPAS-Seaice
    seaice_final_divergence_shear_variational)."""
    div, _, _, delta = strain(geo, u, v, geo.corners(geo.tan_lat))
    ok = geo.corner_ok.to(div.dtype)
    n = ok.sum(1).clamp(min=1.0)
    d = (div * ok).sum(1) / n
    zero = torch.zeros_like(d)
    return (torch.where(solve_stress, -d.clamp(max=0.0), zero),
            torch.where(solve_stress,
                        0.5 * ((delta * ok).sum(1) / n - d.abs()), zero))


def step(ref, state: dict) -> dict:
    tr = {n: state[f"tracers.{n}"] for n in column.TRACERS}
    strength = column_itd.rothrock_strength(tr["iceAreaCategory"],
                                            tr["iceVolumeCategory"])
    vel, solve_stress = solve(
        ref.vgeo, {k: state[f"velocity.{k}"] for k in VELOCITY},
        tr["iceAreaCategory"], tr["iceVolumeCategory"],
        tr["snowVolumeCategory"], ref.wind, ref.dt, ref.n_sub, strength)
    ref.ridge_rates = ridge_rates(ref.vgeo, vel["u_velocity"],
                                  vel["v_velocity"], solve_stress)
    tr = ref.column_transport.remap(ref.tgeo, tr, vel["u_velocity"],
                                    vel["v_velocity"], ref.dt)
    out = dict(state)
    out.update({f"velocity.{k}": v for k, v in vel.items()})
    out.update({f"tracers.{k}": v for k, v in tr.items()})
    return out
