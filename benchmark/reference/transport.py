"""The reference's transport: incremental remapping (Dukowicz and Baumgardner;
Lipscomb and Hunke; the MPAS-Seaice scheme) of a tree of tracers, written
from the scheme in plain PyTorch.

Per step:
  * each cell's field is reconstructed linearly in the cell's tangent
    plane: a least-squares gradient from the differences to its neighbours
    along the directions of its edges' midpoints, limited so that the
    values at the cell's corners stay within its neighbourhood's range,
    centred so that the cell's mean is kept (the mean about the centroid
    for the mass, about the parent's barycentre for each tracer); a
    tracer's mass-tracer product is the product of the linear functions of
    its chain;
  * the region that crosses an edge in a step is the quadrilateral from
    the edge's two vertices to their departure points (backwards along
    the vertex velocity), in the edge's tangent plane; it is clipped
    against each cell that meets the edge's vertices (by the half-planes
    of that cell's edges at those vertices), and each piece's integral of
    the product, taken in the cell's own plane by Green's theorem, is the
    flux of that cell's material (signed by the winding of the
    quadrilateral: out of the edge's first cell is positive);
  * the mass and the mass-tracer products are updated by the flux
    divergence, and each tracer recovered from its product.

Cell averages of moments (centroids and barycentres) follow the MPAS
convention: the triangles from the centre to each edge weighted by
dcEdge x dvEdge."""

from __future__ import annotations

import numpy as np
import torch

from .velocity import rotated, tangent_basis

EPS11 = 1.0e-11
SMALL_MASS = 1.0e-22
BIG = 1.0e30

# the MPAS standard tracer tree of the dynamical core: (name, parent,
# stored as a product with its parent)
TREE = (("iceAreaCategory", None, False),
        ("iceVolumeCategory", "iceAreaCategory", True),
        ("snowVolumeCategory", "iceAreaCategory", True),
        ("surfaceTemperature", "iceAreaCategory", False),
        ("iceEnthalpy", "iceVolumeCategory", False),
        ("iceSalinity", "iceVolumeCategory", False),
        ("snowEnthalpy", "snowVolumeCategory", False))
HAS_CHILD = {p for _, p, _ in TREE if p}

# monomials x^a y^b up to degree 4
MONO = [(a, d - a) for d in range(5) for a in range(d, -1, -1)]
MI = {m: i for i, m in enumerate(MONO)}


def _gl(m):
    x, w = np.polynomial.legendre.leggauss(m)
    return 0.5 * (x + 1.0), 0.5 * w


def triangle_mean_moments(bx, by, cx, cy, deg=4):
    """The mean of every monomial up to `deg` over triangles (0, B, C)
    [..., ] (torch): [..., len(MONO)], by a collapsed Gauss rule exact
    to degree 6."""
    x, w = _gl(4)
    u, t = np.meshgrid(x, x, indexing="ij")
    wu, wt = np.meshgrid(w, w, indexing="ij")
    u, t, w = (torch.as_tensor(a.ravel(), dtype=bx.dtype, device=bx.device)
               for a in (u, t, 2.0 * wu * wt * u))
    qx = u * ((1 - t) * bx[..., None] + t * cx[..., None])
    qy = u * ((1 - t) * by[..., None] + t * cy[..., None])
    return torch.stack([(qx ** a * qy ** b * w).sum(-1)
                        for a, b in MONO if a + b <= deg], -1)


def polygon_moments(px, py, deg=3):
    """Integrals of the monomials up to `deg` over closed polygons
    (px, py) [..., K] (torch; any winding, repeated points allowed), by
    Green's theorem: int x^a y^b dA = (1 / (a + 1)) of the loop integral of
    x^(a+1) y^b dy, each side by 3-point Gauss (exact here)."""
    qx, qw = _gl(3)
    qx = torch.as_tensor(qx, dtype=px.dtype, device=px.device)
    qw = torch.as_tensor(qw, dtype=px.dtype, device=px.device)
    x0, y0 = px[..., None], py[..., None]
    dx = (torch.roll(px, -1, -1) - px)[..., None]
    dy = (torch.roll(py, -1, -1) - py)[..., None]
    X = x0 + qx * dx                                    # [..., K, 3]
    Y = y0 + qx * dy
    wdy = qw * dy
    out = []
    for a, b in MONO:
        if a + b > deg:
            continue
        out.append((X ** (a + 1) * Y ** b * wdy).sum((-1, -2)) / (a + 1))
    return torch.stack(out, -1)


def clip(px, py, ax, ay, bx, by, sgn):
    """Clip polygons (px, py) [N, K] to the half-plane on the side `sgn`
    (+1 left) of the line a -> b [N].  The pieces outside are replaced by
    their projections on the line, which leaves the integral over the
    half-plane of the polygon's winding number as it was; [N, 2K]."""
    dx, dy = (bx - ax)[:, None], (by - ay)[:, None]
    ax, ay = ax[:, None], ay[:, None]

    def side(x, y):
        return sgn[:, None] * (dx * (y - ay) - dy * (x - ax))

    qx, qy = torch.roll(px, -1, 1), torch.roll(py, -1, 1)
    sp, sq = side(px, py), side(qx, qy)
    inp, inq = sp >= 0, sq >= 0
    cross = inp != inq
    t = torch.where(cross, sp / torch.where(cross, sp - sq, 1.0), 0.0)
    xx, xy = px + t * (qx - px), py + t * (qy - py)
    ll = (dx * dx + dy * dy).clamp(min=1e-300)
    s = ((qx - ax) * dx + (qy - ay) * dy) / ll
    jx, jy = ax + s * dx, ay + s * dy                  # q on the line
    fx = torch.where(inp & inq, qx, torch.where(cross, xx, jx))
    fy = torch.where(inp & inq, qy, torch.where(cross, xy, jy))
    gx = torch.where(inq, qx, torch.where(cross, xx, jx))
    gy = torch.where(inq, qy, torch.where(cross, xy, jy))
    n, k = px.shape
    return (torch.stack([fx, gx], -1).reshape(n, 2 * k),
            torch.stack([fy, gy], -1).reshape(n, 2 * k))


class RemapGeometry:
    """The mesh as the transport sees it (torch, on the device)."""

    def __init__(self, mesh, dtype, device):
        nc, me = mesh.vertices_on_cell.shape
        voc = mesh.vertices_on_cell
        ok = voc >= 0
        cr = rotated(mesh.cell_xyz)
        vr = rotated(mesh.vertex_xyz)
        ec, nc_ = tangent_basis(cr)
        pv = vr[np.maximum(voc, 0)] - cr[:, None]
        xl = np.where(ok, (pv * ec[:, None]).sum(-1), 0.0)
        yl = np.where(ok, (pv * nc_[:, None]).sum(-1), 0.0)
        k = np.arange(me)[None, :]
        nxt = np.where(k + 1 < mesh.n_corners[:, None], k + 1, 0)
        xn = np.take_along_axis(xl, nxt, 1)
        yn = np.take_along_axis(yl, nxt, 1)
        eoc = mesh.edges_on_cell
        eo = np.maximum(eoc, 0)

        # cell means of the monomials: fan triangles weighted by dc dv
        wt = np.where(ok, 0.25 * mesh.dc_edge[eo] * mesh.dv_edge[eo], 0.0)
        wt = wt / wt.sum(1, keepdims=True)
        tm = triangle_mean_moments(*(torch.as_tensor(a, dtype=torch.float64)
                                     for a in (xl, yl, xn, yn)))
        mom = (tm * torch.as_tensor(wt)[..., None]).sum(1).numpy()

        # least squares: outward unit directions of the edges' midpoints
        mx, my = 0.5 * (xl + xn), 0.5 * (yl + yn)
        ln = np.hypot(mx, my)
        good = ok & (ln > 0)
        nx_ = np.where(good, mx / np.where(good, ln, 1.0), 0.0)
        ny_ = np.where(good, my / np.where(good, ln, 1.0), 0.0)
        G = np.stack([np.stack([(nx_ * nx_).sum(1), (nx_ * ny_).sum(1)], -1),
                      np.stack([(nx_ * ny_).sum(1), (ny_ * ny_).sum(1)],
                               -1)], -2)
        solvable = good.sum(1) >= 2
        G[~solvable] = np.eye(2)
        Gi = np.linalg.inv(G)
        lsq = np.einsum("cij,ckj->cki", Gi, np.stack([nx_, ny_], -1))
        lsq = np.where((good & solvable[:, None])[..., None], lsq, 0.0)

        # each edge's stencil: its two cells and the third cell at each
        # of its vertices, with the lines of their edges at those
        # vertices, all in the edge's tangent plane
        coe, voe = mesh.cells_on_edge, mesh.vertices_on_edge
        cov = mesh.cells_on_vertex
        ne = len(coe)

        def third(v):
            c = cov[v]
            return c[np.arange(ne), ((c != coe[:, :1]) &
                                     (c != coe[:, 1:])).argmax(1)]

        stencil = np.stack([coe[:, 0], coe[:, 1], third(voe[:, 0]),
                            third(voe[:, 1])], 1)          # [ne, 4]
        epos = vr[voe[:, 0]] + vr[voe[:, 1]]
        epos *= mesh.radius / np.linalg.norm(epos, axis=1, keepdims=True)
        ee, en = tangent_basis(epos)

        def to_edge(p):                       # [ne, ..., 3] -> x, y
            d = p - epos.reshape((ne,) + (1,) * (p.ndim - 2) + (3,))
            shp = (ne,) + (1,) * (p.ndim - 2) + (3,)
            return (d * ee.reshape(shp)).sum(-1), (d * en.reshape(shp)).sum(-1)

        def neighbours_at(cells, v):
            """The corners before and after vertex v in each cell's ring."""
            ring = voc[cells]                                   # [ne, me]
            n = mesh.n_corners[cells][:, None]
            j = (ring == v[:, None]).argmax(1)[:, None]
            prv = np.take_along_axis(ring, (j - 1) % n, 1)[:, 0]
            nxv = np.take_along_axis(ring, (j + 1) % n, 1)[:, 0]
            return prv, nxv

        lines = []      # per stencil slot: [ne, L, 2 (ends)] vertex ids
        v1, v2 = voe[:, 0], voe[:, 1]
        for s in (0, 1):
            c = stencil[:, s]
            p1, n1 = neighbours_at(c, v1)
            p2, n2 = neighbours_at(c, v2)
            o1 = np.where(p1 == v2, n1, p1)    # C's other corner at v1
            o2 = np.where(p2 == v1, n2, p2)
            lines.append(np.stack([np.stack([v1, v2], 1),
                                   np.stack([v1, o1], 1),
                                   np.stack([v2, o2], 1)], 1))
        for s, v in ((2, v1), (3, v2)):
            p, n = neighbours_at(stencil[:, s], v)
            lines.append(np.stack([np.stack([v, p], 1),
                                   np.stack([v, n], 1)], 1))
        vx_e, vy_e = to_edge(vr[np.stack([v1, v2], 1)])     # [ne, 2]
        cx_e, cy_e = to_edge(cr[stencil])                    # [ne, 4]
        ends = []
        for s, L in enumerate(lines):
            lx, ly = to_edge(vr[L])                           # [ne, l, 2]
            ax, ay, bx, by = lx[..., 0], ly[..., 0], lx[..., 1], ly[..., 1]
            side = np.sign((bx - ax) * (cy_e[:, s:s + 1] - ay) -
                           (by - ay) * (cx_e[:, s:s + 1] - ax))
            ends.append(np.stack([ax, ay, bx, by, side], -1))
        # the first cell on the left of v1 -> v2: the edge's orientation
        first_left = np.sign((vx_e[:, 1] - vx_e[:, 0]) *
                             (cy_e[:, 0] - vy_e[:, 0]) -
                             (vy_e[:, 1] - vy_e[:, 0]) *
                             (cx_e[:, 0] - vx_e[:, 0]))
        # edge plane -> cell plane, affine: p -> off + R p, with the
        # measure of the edge's plane (divided by det R)
        sc = cr[stencil]                                      # [ne, 4, 3]
        e_c, n_c = ec[stencil], nc_[stencil]
        R = np.stack([np.stack([(ee[:, None] * e_c).sum(-1),
                                (en[:, None] * e_c).sum(-1)], -1),
                      np.stack([(ee[:, None] * n_c).sum(-1),
                                (en[:, None] * n_c).sum(-1)], -1)], -2)
        d = epos[:, None] - sc
        off = np.stack([(d * e_c).sum(-1), (d * n_c).sum(-1)], -1)

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        self.n_cells, self.me = nc, me
        self.xl, self.yl = t(xl), t(yl)
        self.corner_ok = t(ok)
        self.moments = t(mom)                               # [nc, 15]
        self.lsq = t(lsq)                                   # [nc, me, 2]
        self.nbr = t(np.maximum(mesh.cells_on_cell, 0), torch.int64)
        self.nbr_ok = t(mesh.cells_on_cell >= 0)
        self.dc = t(np.where(ok, mesh.dc_edge[eo], 1.0))
        self.eoc = t(eo, torch.int64)
        self.eoc_sign = t(np.where(ok, np.where(coe[eo, 0] ==
                                                np.arange(nc)[:, None],
                                                1.0, -1.0), 0.0))
        self.area = t(mesh.area_cell)
        self.v12 = t(voe, torch.int64)
        self.vxy = t(np.stack([vx_e, vy_e], -1))            # [ne, 2, 2]
        self.stencil = t(stencil, torch.int64)
        self.lines = [t(e) for e in ends]
        self.first_left = t(first_left)
        self.R = t(R)
        self.off = t(off)
        self.det = t(np.linalg.det(R))


def _poly_mul(p, c, gx, gy):
    """A polynomial {(a, b): coefficient} times (c + gx x + gy y)."""
    out = {}
    for (a, b), k in p.items():
        for (da, db), f in (((0, 0), c), ((1, 0), gx), ((0, 1), gy)):
            key = (a + da, b + db)
            out[key] = out[key] + k * f if key in out else k * f
    return out


def _expand(a, nd):
    return a.reshape(a.shape + (1,) * (nd - a.ndim))


def reconstruct(geo: RemapGeometry, fields):
    """{name: (c0, gx, gy)}: each tracer's limited linear function in its
    cells' planes, [nc, ncat(, nl)] each; and {name: polynomial
    {(a, b): coefficient [nc, ncat]}} of the mass-tracer product of every
    tracer without layers."""
    mask_cell = (fields["iceAreaCategory"].sum(1) > 0).to(geo.xl.dtype)
    mom = geo.moments
    centroid = (mom[:, MI[(1, 0)]], mom[:, MI[(0, 1)]])
    lins, polys, bary = {}, {}, {}
    for name, parent, _ in TREE:
        f = fields[name]
        nd = f.ndim
        if parent is None:
            fm = torch.ones_like(f)
        else:
            fm = _expand((fields[parent] > 0).to(f.dtype), nd).expand(
                f.shape)
        fn, mn = f[geo.nbr], fm[geo.nbr]                 # [nc, me, ...]
        ok = _expand(geo.nbr_ok, nd + 1)
        diff = (fn - f[:, None]) / _expand(geo.dc, nd + 1) * ok * mn * \
            fm[:, None]
        gx = (diff * _expand(geo.lsq[..., 0], nd + 1)).sum(1)
        gy = (diff * _expand(geo.lsq[..., 1], nd + 1)).sum(1)
        mc = _expand(mask_cell, nd)
        gx, gy = gx * mc, gy * mc

        if parent is None:
            xb, yb = (_expand(c, nd) for c in centroid)
        else:
            xb, yb = (_expand(c, nd) for c in bary[parent])
        # limiter: the values at the corners within the neighbourhood's
        # range
        m_ok = mn * ok
        hi = torch.maximum(torch.where(m_ok > 0, fn, -BIG).amax(1), f) - f
        lo = torch.minimum(torch.where(m_ok > 0, fn, BIG).amin(1), f) - f
        dxc = _expand(geo.xl, nd + 1) - xb[:, None]
        dyc = _expand(geo.yl, nd + 1) - yb[:, None]
        dev = (gx[:, None] * dxc + gy[:, None] * dyc) * \
            _expand(geo.corner_ok, nd + 1)
        up, down = dev.amax(1).clamp(min=0.0), dev.amin(1).clamp(max=0.0)

        def ratio(local, room):
            need = local.abs() > room.abs()
            return torch.where(need, (room / torch.where(need, local, 1.0))
                               .clamp(min=0.0), 1.0)

        lim = (torch.minimum(ratio(up, hi), ratio(down, lo)) - EPS11) \
            .clamp(min=0.0) * mc
        gx, gy = gx * lim, gy * lim
        c0 = f - gx * xb - gy * yb
        lins[name] = (c0, gx, gy)
        if nd > 2:
            continue
        polys[name] = ({(0, 0): c0, (1, 0): gx, (0, 1): gy}
                       if parent is None else
                       _poly_mul(polys[parent], c0, gx, gy))
        if name in HAS_CHILD:
            p = polys[name]

            def mean(sx, sy):
                return sum(k * mom[:, MI[(a + sx, b + sy)], None]
                           for (a, b), k in p.items())

            m0 = mean(0, 0)
            good = (m0.abs() > 0) & (mc > 0)
            safe = torch.where(good, m0, 1.0)
            bary[name] = (torch.where(good, mean(1, 0) / safe, 0.0),
                          torch.where(good, mean(0, 1) / safe, 0.0))
    return lins, polys


def edge_fluxes(geo: RemapGeometry, lins, polys, u, v, dt, chunk=65536):
    """{name: flux [ne, ncat(, nl)]} of each tracer's mass-tracer product
    out of each edge's first cell in a step of dt."""
    ne = geo.v12.shape[0]
    out = {n: [] for n, _, _ in TREE}
    keys = {n: sorted(p.keys(), key=lambda m: MI[m])
            for n, p in polys.items()}
    for s0 in range(0, ne, chunk):
        s1 = min(s0 + chunk, ne)
        v12 = geo.v12[s0:s1]
        vx, vy = geo.vxy[s0:s1, :, 0], geo.vxy[s0:s1, :, 1]
        dx, dy = -u[v12] * dt, -v[v12] * dt
        moving = ((dx != 0) | (dy != 0)).any(1)
        # the swept quadrilateral v1, v2, d2, d1
        px = torch.stack([vx[:, 0], vx[:, 1], vx[:, 1] + dx[:, 1],
                          vx[:, 0] + dx[:, 0]], 1)
        py = torch.stack([vy[:, 0], vy[:, 1], vy[:, 1] + dy[:, 1],
                          vy[:, 0] + dy[:, 0]], 1)
        sign = geo.first_left[s0:s1] * moving
        acc = {n: 0.0 for n in out}
        for s in range(4):
            qx, qy = px, py
            ln = geo.lines[s][s0:s1]
            for j in range(ln.shape[1]):
                qx, qy = clip(qx, qy, *(ln[:, j, i] for i in range(5)))
            R, off = geo.R[s0:s1, s], geo.off[s0:s1, s]
            cx = off[:, 0:1] + R[:, 0, 0:1] * qx + R[:, 0, 1:2] * qy
            cy = off[:, 1:2] + R[:, 1, 0:1] * qx + R[:, 1, 1:2] * qy
            M = polygon_moments(cx, cy) * \
                (sign / geo.det[s0:s1, s])[:, None]         # [n, 10]
            cell = geo.stencil[s0:s1, s]
            for name, parent, _ in TREE:
                if name in polys:
                    ks = keys[name]
                    co = torch.stack([polys[name][k][cell] for k in ks], -1)
                    acc[name] = acc[name] + \
                        (co * M[:, None, [MI[k] for k in ks]]).sum(-1)
                    continue
                # a tracer with layers: its parent's product times its
                # own linear function, layer by layer
                ks = keys[parent]
                cp = torch.stack([polys[parent][k][cell] for k in ks], -1)
                c0, gx, gy = (a[cell] for a in lins[name])
                part = 0.0
                for lin, (sx, sy) in ((c0, (0, 0)), (gx, (1, 0)),
                                      (gy, (0, 1))):
                    idx = [MI[(a + sx, b + sy)] for a, b in ks]
                    part = part + lin * (cp * M[:, None, idx]).sum(-1)[
                        ..., None]
                acc[name] = acc[name] + part
        for n in out:
            out[n].append(acc[n])
    return {n: torch.cat(v) for n, v in out.items()}


def _tiny(x):
    return x >= torch.finfo(x.dtype).tiny


def remap(geo: RemapGeometry, state, u, v, dt):
    """One transport step of the tracers `state` (as stored: the ice and
    snow volumes as volumes) under the vertex velocities (u, v).  Returns
    the new tracers, stored alike."""
    area = state["iceAreaCategory"]
    fields = {}
    for name, parent, product in TREE:
        f = state[name]
        if product:
            pa = state[parent] if parent != "iceAreaCategory" else area
            f = torch.where(_tiny(pa), f / torch.where(_tiny(pa), pa, 1.0),
                            0.0)
        fields[name] = f
    lins, polys = reconstruct(geo, fields)
    flux = edge_fluxes(geo, lins, polys, u, v, dt)

    # mass-tracer products before, and after the flux divergence
    prod = {}
    for name, parent, _ in TREE:
        f = fields[name]
        prod[name] = f if parent is None else \
            _expand(prod[parent], f.ndim) * f
    new_prod, new = {}, {}
    for name, parent, _ in TREE:
        fl = flux[name][geo.eoc]                       # [nc, me, ...]
        nd = fl.ndim
        div = (fl * _expand(geo.eoc_sign, nd)).sum(1) / \
            _expand(geo.area, nd - 1)
        p = prod[name] - div
        new_prod[name] = p
        if parent is None:
            new[name] = p
            continue
        pp = _expand(new_prod[parent], p.ndim)
        val = torch.where(_tiny(pp), p / torch.where(_tiny(pp), pp, 1.0),
                          0.0)
        # where the new parent product is a sliver (< 1e-8), a ratio of
        # near-cancelled values is kept inside the tracer's range before
        # the step over the cells with a parent product over 1e-11
        old = fields[name]
        meaningful = _expand(prod[parent], old.ndim) > 1e-11
        lo = torch.where(meaningful, old, BIG).amin(0)
        hi = torch.where(meaningful, old, -BIG).amax(0)
        empty = lo > hi
        lo, hi = torch.where(empty, 0.0, lo), torch.where(empty, 0.0, hi)
        val = torch.where(pp < 1e-8, torch.minimum(torch.maximum(val, lo),
                                                   hi), val)
        new[name] = val
        new_prod[name] = pp * val
    # mass under 1e-22 goes, with its tracers
    m = new["iceAreaCategory"]
    zap = (m > 0) & (m < SMALL_MASS)
    for name in new:
        new[name] = torch.where(_expand(zap, new[name].ndim), 0.0,
                                new[name])
    out = {}
    for name, parent, product in TREE:
        f = new[name]
        if product:
            f = f * (new["iceAreaCategory"] if parent == "iceAreaCategory"
                     else out[parent])
        out[name] = f
    return out
