"""Implicit viscous-plastic (VP) momentum solver via JFNK.

A capability the reference does not have (its only implicit-adjacent
option is revised EVP): solve the VP momentum balance directly with a
Jacobian-free Newton-Krylov iteration, where the Jacobian-vector product
comes from `torch.func.jvp` of the residual (no hand-derived
linearization) and the inner solve is a matrix-free restarted GMRES
written here (`gmres`).  Reuses the variational strain/stress-divergence
operators of the EVP path (reference operators:
mpas_seaice_velocity_solver_variational.F).

VP rheology (Hibler 1979):
  zeta = P / (2 max(Delta, Delta_min)),  eta = zeta / e^2
  sigma = 2 eta eps + (zeta - eta) tr(eps) I - P_rep/2 I
with replacement pressure P_rep = P * Delta / (Delta + Delta_min).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .. import constants as c
from ..config import Config
from ..mesh.core import cell_to_vertex
from . import variational
from .evp import (DynamicsForcing, DynamicsTensors, VelocitySolverState,
                  _air_stress, _computation_masks, _ice_strength_hibler,
                  aggregate_mass)

DELTA_MIN = 2.0e-9     # minimum Delta (1/s), standard VP regularization


def vp_stress(e11, e22, e12, pressure):
    """VP stress at cell corners from strain; inputs [nCells, maxEdges],
    pressure [nCells]."""
    div = e11 + e22
    ten = e11 - e22
    shr = 2.0 * e12
    delta = torch.sqrt(div ** 2 + (ten ** 2 + shr ** 2) /
                       c.EVP_ECCENTRICITY_SQ)
    p = pressure[:, None]
    zeta = p / (2.0 * delta.clamp(min=DELTA_MIN))
    eta = zeta / c.EVP_ECCENTRICITY_SQ
    prep = p * delta / (delta + DELTA_MIN)
    s11 = 2.0 * eta * e11 + (zeta - eta) * div - 0.5 * prep
    s22 = 2.0 * eta * e22 + (zeta - eta) * div - 0.5 * prep
    s12 = 2.0 * eta * e12
    return s11, s22, s12


def _dots(V, w):
    """<V[j], w> for every Krylov vector: multiply and sum (no matrix
    product, so no reduced-precision mode can reach it).  V [m, 2, nv],
    w [2, nv] (the pair (u, v) as one vector) -> [m]."""
    return (V * w).sum(dim=(1, 2))


def _norm(w):
    return torch.sqrt((w * w).sum())


def _combine(V, y):
    """sum_j y[j] V[j], multiply and sum -> [2, nv]."""
    return (V * y[:, None, None]).sum(dim=0)


def _safe_normalize(w, thresh):
    """(w / |w|, |w|), or (0, 0) where |w| <= thresh."""
    n = _norm(w)
    use = n > thresh
    unit = torch.where(use, w / n, torch.zeros_like(w))
    return unit, torch.where(use, n, torch.zeros_like(n))


def gmres(A, b, tol: float, restart: int, maxiter: int, counts=None):
    """Solve A(x) = b for x [2, nv] (the pair (u, v) as one vector under
    the sum of both dot products) by restarted GMRES from x0 = 0, with the
    semantics of `jax.scipy.sparse.linalg.gmres(..., atol=0,
    solve_method='batched')`: `restart` Arnoldi steps a cycle (one pass
    of classical Gram-Schmidt; after a breakdown the remaining steps
    leave the basis and the Hessenberg rows as they are), the
    least-squares problem solved by normal equations and a Cholesky
    factorisation, at most `maxiter` cycles, stopping once the residual
    norm is at most tol * |b|.

    The stopping test is the only host synchronisation: one a cycle, and
    one after the last (none when `maxiter` cycles ran).  counts: an
    optional dict whose "restarts" and "host_syncs" are increased."""
    dtype = b.dtype
    eps = torch.finfo(dtype).eps
    restart = min(restart, b.numel())
    atol = tol * _norm(b)
    x = torch.zeros_like(b)
    unit, rnorm = _safe_normalize(b - A(x), eps)
    cycles = syncs = 0
    while cycles < maxiter:
        syncs += 1
        if not bool(rnorm > atol):
            break
        V = torch.zeros((restart + 1,) + tuple(b.shape), dtype=dtype,
                        device=b.device)
        V[0] = unit
        H = torch.eye(restart, restart + 1, dtype=dtype, device=b.device)
        done = torch.zeros((), dtype=torch.bool, device=b.device)
        for k in range(restart):
            w = A(V[k])
            _, n0 = _safe_normalize(w, eps)
            h = _dots(V, w)
            w = w - _combine(V, h)
            w, n1 = _safe_normalize(w, eps * n0)
            h[k + 1] = n1
            V[k + 1] = torch.where(done, V[k + 1], w)
            H[k] = torch.where(done, H[k], h)
            done = done | (n1 == 0)
        beta = torch.zeros(restart + 1, dtype=dtype, device=b.device)
        beta[0] = rnorm
        # least squares min |H^T y - beta| by the normal equations
        gram = (H[:, None, :] * H[None, :, :]).sum(dim=-1)
        rhs = (H * beta).sum(dim=-1)
        chol, _ = torch.linalg.cholesky_ex(gram)
        y = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
        x = x + _combine(V[:-1], y)
        unit, rnorm = _safe_normalize(b - A(x), eps)
        cycles += 1
    if counts is not None:
        counts["restarts"] = counts.get("restarts", 0) + cycles
        counts["host_syncs"] = counts.get("host_syncs", 0) + syncs
    return x


def make_vp_solver(cfg: Config, n_newton: int = 10,
                   gmres_iters: int = 30, gmres_restart: int = 15):
    """Build a VP dynamics step with the same signature as the EVP step
    (evp.make_velocity_solver): step(dyn, state, forcing, area, vol,
    snow, pressure_in=None) -> (state, diags).  Each Newton iteration
    solves its linear system by `gmres` with at most gmres_iters cycles
    of gmres_restart Arnoldi steps, to 1e-8 of the residual.  The diags
    carry, besides the EVP step's, `vp_residual_norm` and the step's
    GMRES cycles (`gmres_restarts`) and host synchronisations
    (`gmres_host_syncs`) as Python ints."""
    v_cfg = cfg.velocity
    dt = cfg.dynamics_timestep

    def step(dyn: DynamicsTensors, state: VelocitySolverState,
             forcing: DynamicsForcing,
             ice_area_cat, ice_volume_cat, snow_volume_cat,
             pressure_in: Optional[Any] = None):
        mesh = dyn.mesh
        mass = aggregate_mass(ice_area_cat, ice_volume_cat,
                              snow_volume_cat)
        (solve_stress, solve_velocity, total_mass, mass_vertex,
         area_vertex) = _computation_masks(mass, forcing, dyn)

        uo_v = cell_to_vertex(mesh, forcing.u_ocean_velocity)
        vo_v = cell_to_vertex(mesh, forcing.v_ocean_velocity)
        if pressure_in is None:
            pressure = _ice_strength_hibler(mass, solve_stress)
        else:
            pressure = torch.where(solve_stress > 0, pressure_in,
                                   torch.zeros_like(pressure_in))
        air_u, air_v = _air_stress(forcing, mass, dyn,
                                   v_cfg.use_air_stress)
        mass_f = mass_vertex * mesh.f_vertex
        sv = solve_velocity > 0
        zero_v = torch.zeros_like(mass_vertex)
        if v_cfg.geostrophic_surface_tilt:
            tilt_u = torch.where(sv, -mesh.f_vertex * mass_vertex * vo_v,
                                 zero_v)
            tilt_v = torch.where(sv, mesh.f_vertex * mass_vertex * uo_v,
                                 zero_v)
        else:
            tilt_u = tilt_v = zero_v

        u_prev = torch.where(sv, state.u_velocity, zero_v)
        v_prev = torch.where(sv, state.v_velocity, zero_v)
        m_dt = mass_vertex / dt
        ss = (solve_stress > 0)[:, None]

        def residual(u, v):
            """The VP momentum residual at (u, v); no in-place operation,
            so that `torch.func.jvp` can differentiate it."""
            e11, e22, e12 = variational.strain_tensor(
                u, v, dyn.tan_lat_vertex, mesh,
                dyn.basis_gradient_u, dyn.basis_gradient_v)
            s11, s22, s12 = vp_stress(e11, e22, e12, pressure)
            zs = torch.zeros_like(s11)
            s11 = torch.where(ss, s11, zs)
            s22 = torch.where(ss, s22, zs)
            s12 = torch.where(ss, s12, zs)
            div_u, div_v = variational.stress_divergence(
                s11, s22, s12, dyn.tan_lat_vertex, mesh,
                dyn.basis_integrals_u, dyn.basis_integrals_v,
                dyn.basis_integrals_metric,
                dyn.variational_denominator, solve_velocity)
            rel = torch.sqrt((uo_v - u) ** 2 + (vo_v - v) ** 2)
            cw = c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER * area_vertex * \
                rel
            tau_ou = cw * (uo_v - u)
            tau_ov = cw * (vo_v - v)
            fu = m_dt * (u - u_prev) - div_u - air_u - tau_ou - \
                tilt_u + mass_f * v * (-1.0)
            fv = m_dt * (v - v_prev) - div_v - air_v - tau_ov - \
                tilt_v + mass_f * u
            return torch.where(sv, fu, u), torch.where(sv, fv, v)

        counts = {}
        # free-drift warm start where the previous velocity is at rest:
        # quadratic-drag balance |tau_air| = Cw rho_w a |u - uo|^2 gives
        # the velocity scale; Newton from exactly zero velocity stalls in
        # the rigid (Delta -> 0, zeta -> P/2Delta_min) limit
        tau_mag = torch.sqrt(air_u ** 2 + air_v ** 2)
        cw0 = (c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER *
               area_vertex).clamp(min=c.PUNY)
        u_fd_mag = torch.sqrt(tau_mag / cw0)
        tdir = tau_mag.clamp(min=c.PUNY)
        u_fd = uo_v + u_fd_mag * air_u / tdir
        v_fd = vo_v + u_fd_mag * air_v / tdir
        at_rest = (u_prev ** 2 + v_prev ** 2) < 1e-12
        uv = torch.stack([
            torch.where(sv, torch.where(at_rest, u_fd, u_prev), zero_v),
            torch.where(sv, torch.where(at_rest, v_fd, v_prev), zero_v)])
        for _ in range(n_newton):
            F = torch.stack(residual(uv[0], uv[1]))

            def jvp_op(w, uv=uv):
                return torch.stack(torch.func.jvp(
                    residual, (uv[0], uv[1]), (w[0], w[1]))[1])

            uv = uv + gmres(jvp_op, -F, tol=1e-8, restart=gmres_restart,
                            maxiter=gmres_iters, counts=counts)
        u, v = uv[0], uv[1]

        # final diagnostics (same as the EVP post-subcycle)
        e11, e22, e12 = variational.strain_tensor(
            u, v, dyn.tan_lat_vertex, mesh,
            dyn.basis_gradient_u, dyn.basis_gradient_v)
        s11, s22, s12 = vp_stress(e11, e22, e12, pressure)
        div, shear, ridge_conv, ridge_shear = \
            variational.final_divergence_shear(
                e11, e22, e12, mesh, solve_stress,
                c.EVP_ECCENTRICITY_SQ)
        res = residual(u, v)
        res_norm = torch.sqrt((res[0] ** 2 + res[1] ** 2).sum())

        new_state = VelocitySolverState(
            u_velocity=u, v_velocity=v,
            stress11=s11, stress22=s22, stress12=s12,
            solve_velocity_prev=solve_velocity.to(u.dtype))
        diags = {
            "divergence": div, "shear": shear,
            "ridge_convergence": ridge_conv, "ridge_shear": ridge_shear,
            "ice_pressure": pressure,
            "solve_stress": solve_stress,
            "solve_velocity": solve_velocity,
            "vp_residual_norm": res_norm,
            "gmres_restarts": counts.get("restarts", 0),
            "gmres_host_syncs": counts.get("host_syncs", 0),
        }
        return new_state, diags

    return step
