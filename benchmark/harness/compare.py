"""The comparison that decides `correct`.

The program's steps are compared one by one with the reference's: for
each sampled step of the window, the reference (`benchmark/reference`,
plain PyTorch in float64 that imports nothing of the program) takes the
program's state from before that step, makes the step itself from the
same configuration and seeded inputs, and its result is set beside the
program's.  The start is
checked by itself: the initial state the program built from the seeded
inputs against the one the reference built from the same inputs.

What is compared are the cell's amounts (`benchmark/workloads/<cell>.json`,
"amounts", in groups such as "dynamics" and "ice"): each a product of
state fields, such as the ice energy iceEnthalpy x iceVolumeCategory, or a
field alone, such as a velocity.

Numbers, each the largest over the amounts and over the samples:
  * start_gap: sum|P - R| / sum|R| of the initial states, every amount;
  * <group>.state_gap: sum|P - R| / sum|R| of the states after the step;
  * <group>.increment_gap: sum|P - R| / sum|R - X|, the error against
    what the step changed (X: the state before it), over the amounts the
    reference's step changes by more than 1e-6 of their size.
The cell's "limits" name the numbers compared; the others are printed as
readings only."""

from __future__ import annotations

import numpy as np

MOVED = 1e-6


class Mapping:
    """Moves flattened program fields into the reference's order: cells
    and vertices matched by position (nearest point, which must lie
    within a millimetre), and each cell's corners by their vertices."""

    def __init__(self, prog_mesh, ref_mesh):
        from scipy.spatial import cKDTree
        pc = np.stack([prog_mesh.x_cell, prog_mesh.y_cell,
                       prog_mesh.z_cell], 1)
        pv = np.stack([prog_mesh.x_vertex, prog_mesh.y_vertex,
                       prog_mesh.z_vertex], 1)
        if (len(pc), len(pv)) != (ref_mesh.n_cells, ref_mesh.n_vertices):
            raise ValueError("the program's mesh and the reference's "
                             "differ in size")
        dc, self.cell = cKDTree(ref_mesh.cell_xyz).query(pc)
        dv, self.vertex = cKDTree(ref_mesh.vertex_xyz).query(pv)
        if max(dc.max(), dv.max()) > 1e-3:
            raise ValueError("the program's mesh and the reference's "
                             "hold different points")
        self.n_cells, self.n_vertices = len(pc), len(pv)
        # corner k of program cell c is corner slot[c, k] of its match
        voc = prog_mesh.vertices_on_cell
        ok = voc >= 0
        ring = ref_mesh.vertices_on_cell[self.cell]          # [nc, me]
        want = np.where(ok, self.vertex[np.maximum(voc, 0)], -2)
        hit = ring[:, None, :] == want[:, :, None]
        if not (hit.any(-1) == ok).all():
            raise ValueError("the program's cells and the reference's "
                             "have different corners")
        self.corner_ok = ok
        self.slot = hit.argmax(-1)

    def __call__(self, fields: dict) -> dict:
        out = {}
        for k, a in fields.items():
            a = np.asarray(a)
            if k.startswith("velocity.stress"):
                b = np.zeros_like(a)
                rows = np.broadcast_to(self.cell[:, None], a.shape)
                b[rows[self.corner_ok], self.slot[self.corner_ok]] = \
                    a[self.corner_ok]
            elif k.startswith("velocity.") and a.ndim and \
                    a.shape[0] == self.n_vertices:
                b = np.empty_like(a)
                b[self.vertex] = a
            elif a.ndim and a.shape[0] == self.n_cells:
                b = np.empty_like(a)
                b[self.cell] = a
            else:
                b = a
            out[k] = b
        return out


def to_numpy(fields: dict) -> dict:
    out = {}
    for k, v in fields.items():
        if hasattr(v, "detach"):
            v = v.detach().to("cpu").double().numpy()
        out[k] = v
    return out


def _l1(a):
    return float(np.abs(a).sum())


def amounts(fields: dict, spec: dict) -> dict:
    """{amount: float64 array} of flattened state fields (numpy): each
    amount the product of its fields, the ones with fewer axes broadcast
    over the trailing axes of the others."""
    out = {}
    for name, factors in spec.items():
        if not all(f in fields for f in factors):
            continue
        arrs = [np.asarray(fields[f], np.float64) for f in factors]
        nd = max(a.ndim for a in arrs)
        prod = np.ones(())
        for a in arrs:
            prod = prod * a.reshape(a.shape + (1,) * (nd - a.ndim))
        out[name] = prod
    return out


def field_gaps(P: dict, R: dict, spec: dict, X: dict = None):
    """{amount: (state gap, increment gap or None)} of flattened states
    P (the program's) and R (the reference's), X the state before the
    step."""
    P, R = amounts(P, spec), amounts(R, spec)
    X = amounts(X, spec) if X is not None else None
    out = {}
    for k, r in R.items():
        p = P.get(k)
        if p is None or p.shape != r.shape or not (
                np.isfinite(p).all() and np.isfinite(r).all()):
            out[k] = (float("inf"), float("inf"))
            continue
        diff = _l1(p - r)
        size = _l1(r) or _l1(p)
        state = diff / size if size else 0.0
        inc = None
        if X is not None:
            moved = _l1(r - X[k])
            if size and moved > MOVED * size:
                inc = diff / moved
        out[k] = (state, inc)
    return out


def flat_spec(spec: dict) -> dict:
    """Every amount of every group."""
    return {k: v for group in spec.values() for k, v in group.items()}


def numbers(P: dict, R: dict, spec: dict, X: dict):
    """{"<group>.state_gap" and "<group>.increment_gap": (value, amount)}
    of one step."""
    out = {}
    for group, amts in spec.items():
        gaps = field_gaps(P, R, amts, X)
        out[f"{group}.state_gap"] = worst(gaps, 0)
        out[f"{group}.increment_gap"] = worst(gaps, 1)
    return out


def larger(a: dict, b: dict) -> dict:
    """The larger reading of each number of two (value, amount) dicts."""
    out = dict(a)
    for k, v in b.items():
        if k not in out or v[0] > out[k][0]:
            out[k] = v
    return out


def worst(gaps: dict, which: int):
    """(value, field) of the largest gap of one kind."""
    best = (0.0, None)
    for k, g in gaps.items():
        v = g[which]
        if v is not None and (best[1] is None or v > best[0]):
            best = (v, k)
    return best


def verdict(numbers: dict, limits: dict, failed: int, attempted: int):
    """correct: every number at or under its limit, no failed step, and
    every step of the window attempted."""
    ok = failed == 0 and attempted > 0
    for k, v in numbers.items():
        lim = limits.get(k)
        if lim is None or v is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok
