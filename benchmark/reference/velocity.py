"""The reference's velocity solve: MPAS-Seaice's EVP rheology with the
variational (finite-element) stress divergence on Wachspress functions,
written from the equations in plain PyTorch.

On each cell the velocities of its corners are interpolated by the
Wachspress functions of its polygon, projected onto the cell's tangent
plane in the rotated grid (the geographic poles turned onto the equator).
Each elastic subcycle:
  * strain rates at every corner from the corner gradients of the
    functions, with the metric terms tan(lat)/R of the rotated grid;
  * the EVP stress relaxation at every corner (Hunke and Dukowicz, with
    the replacement pressure);
  * the stress divergence at each vertex, the weak form: minus the
    integrals of stress x the gradient of the vertex's function (and
    stress x function x tan(lat)/R), over the cells around it, divided by
    the vertex's triangle area;
  * the implicit 2x2 momentum solve with Coriolis and quadratic ocean
    drag against an ocean at rest, under the wind's stress.

The Wachspress functions are evaluated from triangle areas (phi_i =
w_i / sum w, w_i = C_i / (A_{i-1} A_i)) and their gradients by Floater's
formula; at a corner, where those areas vanish, the gradients follow from
the functions being linear along the corner's two edges.  The integrals
are Gauss-Legendre sums over the triangles from the cell's centre to
each of its edges (collapsed onto the triangle, 8 x 8 points)."""

from __future__ import annotations

import numpy as np
import torch

DENSITY_ICE = 917.0
DENSITY_SNOW = 330.0
DENSITY_SEAWATER = 1026.0
ICE_STRENGTH_P = 2.75e4            # Hibler's P* (N m-2)
ICE_STRENGTH_C = 20.0              # Hibler's C*
ICE_OCEAN_DRAG = 0.00536
AIR_DRAG = 0.0012
ECCENTRICITY_SQ = 4.0
DAMPING = 0.36                     # damping timescale / dynamics step
PUNY = 1.0e-11
ICE_AREA_MINIMUM = 0.001
ICE_MASS_MINIMUM = 0.01


def rotated(xyz):
    """The rotated grid: the north pole (0, 0, 1) goes to (-1, 0, 0)."""
    return np.stack([-xyz[..., 2], xyz[..., 1], xyz[..., 0]], -1)


def tangent_basis(p):
    """Unit east and north vectors [..., 3] at points p [..., 3]; at a
    pole of the frame, where east is undefined, the x axis stands in for
    the z axis."""
    r = p / np.linalg.norm(p, axis=-1, keepdims=True)
    e = np.cross(np.array([0.0, 0.0, 1.0]), r)
    pole = np.linalg.norm(e, axis=-1, keepdims=True) < 1e-6
    e = np.where(pole, np.cross(np.array([1.0, 0.0, 0.0]), r), e)
    e = e / np.linalg.norm(e, axis=-1, keepdims=True)
    return e, np.cross(r, e)


def gauss_triangle(m: int):
    """(u, t, w) of an m x m Gauss-Legendre rule collapsed onto the
    triangle {u ((1 - t) B + t C)} with apex 0: the point u((1-t)B + tC)
    and weight w, to be multiplied by |B x C|."""
    x, w = np.polynomial.legendre.leggauss(m)
    x, w = 0.5 * (x + 1.0), 0.5 * w
    u, t = np.meshgrid(x, x, indexing="ij")
    wu, wt = np.meshgrid(w, w, indexing="ij")
    return u.ravel(), t.ravel(), (wu * wt * u).ravel()


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def wachspress(xl, yl, m: int = 8):
    """Corner gradients and integrals of the Wachspress functions of
    convex polygons with counter-clockwise corners (xl, yl) [nc, n]
    (torch, the cell's centre at the origin).

    Returns gx, gy [nc, n(b), n(g)]: d(phi_b)/dx, /dy at corner g; and
    su, sv, sm [nc, n(s), n(g)]: the integrals of phi_s dphi_g/dx,
    phi_s dphi_g/dy and phi_s phi_g over the polygon."""
    nc, n = xl.shape
    dt, dev = xl.dtype, xl.device
    nx_, ny_ = torch.roll(xl, -1, 1), torch.roll(yl, -1, 1)     # v_{i+1}
    px_, py_ = torch.roll(xl, 1, 1), torch.roll(yl, 1, 1)       # v_{i-1}

    # corner gradients: phi is linear along both edges of a corner, so
    # grad phi . (v_{g+1} - v_g) and grad phi . (v_{g-1} - v_g) are known
    ax, ay = nx_ - xl, ny_ - yl
    bx, by = px_ - xl, py_ - yl
    det = _cross(ax, ay, bx, by)

    def solve(ra, rb):          # grad with grad.a = ra, grad.b = rb
        return (ra * by - rb * ay) / det, (rb * ax - ra * bx) / det

    gx = torch.zeros((nc, n, n), dtype=dt, device=dev)
    gy = torch.zeros_like(gx)
    g = torch.arange(n, device=dev)
    for b_off, (ra, rb) in ((0, (-1.0, -1.0)), (1, (1.0, 0.0)),
                            (-1, (0.0, 1.0))):
        ux, uy = solve(torch.full_like(det, ra), torch.full_like(det, rb))
        gx[:, (g + b_off) % n, g] = ux
        gy[:, (g + b_off) % n, g] = uy

    # integrals over the fan of triangles (0, v_s, v_{s+1})
    u, t, w = (torch.as_tensor(a, dtype=dt, device=dev)
               for a in gauss_triangle(m))
    qx = u[None, None, :] * ((1 - t)[None, None, :] * xl[..., None] +
                             t[None, None, :] * nx_[..., None])
    qy = u[None, None, :] * ((1 - t)[None, None, :] * yl[..., None] +
                             t[None, None, :] * ny_[..., None])
    jac = _cross(xl, yl, nx_, ny_)[..., None] * w        # [nc, n(tri), Q]
    qx = qx.reshape(nc, 1, -1)
    qy = qy.reshape(nc, 1, -1)
    # A_i(x): signed area of (x, v_i, v_{i+1}); its gradient
    A = 0.5 * _cross(xl[..., None] - qx, yl[..., None] - qy,
                     nx_[..., None] - qx, ny_[..., None] - qy)
    dAx = (0.5 * (yl - ny_))[..., None]
    dAy = (0.5 * (nx_ - xl))[..., None]
    C = 0.5 * _cross(xl - px_, yl - py_, nx_ - px_, ny_ - py_)
    Am = torch.roll(A, 1, 1)                     # A_{i-1}
    dAmx, dAmy = torch.roll(dAx, 1, 1), torch.roll(dAy, 1, 1)
    wgt = C[..., None] / (Am * A)
    phi = wgt / wgt.sum(1, keepdim=True)                 # [nc, n, P]
    Rx = -(dAmx / Am + dAx / A)
    Ry = -(dAmy / Am + dAy / A)
    dpx = phi * (Rx - (phi * Rx).sum(1, keepdim=True))
    dpy = phi * (Ry - (phi * Ry).sum(1, keepdim=True))
    wj = jac.reshape(nc, 1, -1)
    su = torch.einsum("csp,cgp->csg", phi * wj, dpx)
    sv = torch.einsum("csp,cgp->csg", phi * wj, dpy)
    sm = torch.einsum("csp,cgp->csg", phi * wj, phi)
    return gx, gy, su, sv, sm


class VelocityGeometry:
    """What the solve needs of the mesh, on the device in `dtype`: corner
    tables [nc, me] (Wachspress operators [nc, me, me]), the vertices'
    cells and their corner in each, tan(lat)/R in the rotated grid, the
    Coriolis parameter, triangle areas and the cell-to-vertex weights."""

    def __init__(self, mesh, dtype, device, chunk=8192):
        nc, me = mesh.vertices_on_cell.shape
        f64 = torch.float64
        voc = mesh.vertices_on_cell
        ok = voc >= 0
        cr = rotated(mesh.cell_xyz)
        vr = rotated(mesh.vertex_xyz)
        e, n = tangent_basis(cr)
        pv = vr[np.maximum(voc, 0)]                       # [nc, me, 3]
        xl = np.where(ok, (pv * e[:, None]).sum(-1), 0.0)
        yl = np.where(ok, (pv * n[:, None]).sum(-1), 0.0)
        ops = [np.zeros((nc, me, me)) for _ in range(5)]
        for k in np.unique(mesh.n_corners):
            rows = np.nonzero(mesh.n_corners == k)[0]
            for s in range(0, len(rows), chunk):
                r = rows[s:s + chunk]
                res = wachspress(
                    torch.as_tensor(xl[r, :k], dtype=f64, device=device),
                    torch.as_tensor(yl[r, :k], dtype=f64, device=device))
                for dst, src in zip(ops, res):
                    dst[r[:, None, None], np.arange(k)[:, None],
                        np.arange(k)[None, :]] = src.cpu().numpy()

        # each vertex's cells and the vertex's corner in each
        cov = mesh.cells_on_vertex
        corner = (voc[cov] == np.arange(len(cov))[:, None, None]).argmax(-1)
        w = mesh.area_cell[cov]

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        self.voc = t(np.maximum(voc, 0), torch.int64)
        self.corner_ok = t(ok)
        self.gx, self.gy, self.su, self.sv, self.sm = (t(a) for a in ops)
        self.cov = t(cov, torch.int64)
        self.cov_corner = t(corner, torch.int64)
        self.c2v = t(w / w.sum(1, keepdims=True))
        self.cells_on_cell = t(np.maximum(mesh.cells_on_cell, 0),
                               torch.int64)
        self.coc_ok = t(mesh.cells_on_cell >= 0)
        lat_r = np.arcsin(np.clip(vr[:, 2] / mesh.radius, -1, 1))
        self.tan_lat = t(np.tan(lat_r) / mesh.radius)
        self.f = t(mesh.f_vertex)
        self.area_triangle = t(mesh.area_triangle)

    def to_vertex(self, a):
        """Area-weighted mean over a vertex's cells."""
        return (a[self.cov] * self.c2v).sum(1)

    def corners(self, a):
        """A vertex field at every corner [nc, me]."""
        return a[self.voc] * self.corner_ok


def solve(geo: VelocityGeometry, vel: dict, area, volume, snow, wind,
          dt: float, n_sub: int):
    """One velocity solve.  vel: u, v [nv], stress11/22/12 [nc, me] and
    solve_velocity_prev [nv]; area, volume, snow [nc, ncat]; wind: (u, v,
    air density) [nc] in the rotated grid's east and north.  Returns the
    new vel dict."""
    a = area.sum(1)
    mass = volume.sum(1) * DENSITY_ICE + snow.sum(1) * DENSITY_SNOW
    ice = ((a > ICE_AREA_MINIMUM) & (mass > ICE_MASS_MINIMUM)).to(a.dtype)
    nb = (ice[geo.cells_on_cell] * geo.coc_ok).amax(1)
    solve_stress = torch.maximum(ice, nb) > 0
    a_v = geo.to_vertex(a)
    m_v = geo.to_vertex(mass)
    sv = (a_v > ICE_AREA_MINIMUM) & (m_v > ICE_MASS_MINIMUM)

    zero = torch.zeros_like(a_v)
    # ice new at a vertex starts at the ocean's velocity, at rest here
    new = sv & (vel["solve_velocity_prev"] == 0)
    u = torch.where(sv & ~new, vel["u_velocity"], zero)
    v = torch.where(sv & ~new, vel["v_velocity"], zero)

    pressure = torch.where(solve_stress, ICE_STRENGTH_P * volume.sum(1) *
                           torch.exp(-ICE_STRENGTH_C * (1.0 - a)),
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
    for _ in range(n_sub):
        uc, vc = geo.corners(u), geo.corners(v)
        dudx = torch.einsum("cb,cbg->cg", uc, geo.gx)
        dudy = torch.einsum("cb,cbg->cg", uc, geo.gy)
        dvdx = torch.einsum("cb,cbg->cg", vc, geo.gx)
        dvdy = torch.einsum("cb,cbg->cg", vc, geo.gy)
        e11 = dudx - vc * tl_c
        e22 = dvdy
        e12 = 0.5 * (dudy + dvdx + uc * tl_c)
        div, ten, shr = e11 + e22, e11 - e22, 2.0 * e12
        delta = torch.sqrt(div * div + (ten * ten + shr * shr) /
                           ECCENTRICITY_SQ)
        c = pressure / delta.clamp(min=PUNY) * dte / (2.0 * T)
        sig1 = (s11 + s22 + c * (div - delta)) / denom
        sig2 = (s11 - s22 + c / ECCENTRICITY_SQ * ten) / denom
        n12 = (s12 + c / ECCENTRICITY_SQ * 0.5 * shr) / denom
        s11 = torch.where(ss, 0.5 * (sig1 + sig2), s11)
        s22 = torch.where(ss, 0.5 * (sig1 - sig2), s22)
        s12 = torch.where(ss, n12, s12)

        # weak-form divergence at each vertex from its cells
        def at_vertex(ints, s):
            per = torch.einsum("cs,csg->cg", s, ints)
            return per[geo.cov, geo.cov_corner].sum(1)

        fu = -(at_vertex(geo.su, s11) + at_vertex(geo.sv, s12) +
               geo.tan_lat * at_vertex(geo.sm, s12))
        fv = -(at_vertex(geo.sv, s22) + at_vertex(geo.su, s12)) + \
            geo.tan_lat * at_vertex(geo.sm, s11)
        fu = fu / geo.area_triangle
        fv = fv / geo.area_triangle

        # implicit point solve: (m/dte + c_o) u - m f v = rhs_u, ...
        drag = ICE_OCEAN_DRAG * DENSITY_SEAWATER * a_v * \
            torch.sqrt(u * u + v * v)
        a11 = m_v / dte + drag
        ru = fu + tau_u + m_v * u / dte
        rv = fv + tau_v + m_v * v / dte
        d = a11 * a11 + mf * mf
        d = torch.where(d == 0, torch.ones_like(d), d)
        un = (a11 * ru + mf * rv) / d
        vn = (a11 * rv - mf * ru) / d
        u = torch.where(sv, un, u)
        v = torch.where(sv, vn, v)
    return {"u_velocity": u, "v_velocity": v, "stress11": s11,
            "stress22": s22, "stress12": s12,
            "solve_velocity_prev": sv.to(u.dtype)}
