#!/usr/bin/env python3
"""Replay K2's arithmetic (`seaice_tpu_torch/csrc/ir_flux.cu`) on the
edges that `dev/bl99_coupled_witness.py --compare-flux` recorded, on the
CPU in numpy at the dtype of the card's run: each 2D column's chain of
linear factors at the six quadrature points multiplied from the column
up to the root (the kernel's order) and from the root down to the column
(the plain version's order, `remap.integrate_fluxes`, which builds a
child's product from its parent's), weighted, summed over the slots and
masked.  Prints, for each order, the tracer columns that come out
non-finite beside the card's K2 and plain fluxes there, and the linear
factors of the first such column's chain at its first non-finite point.

    python3 dev/replay_k2_edges.py WITNESS.log
"""

import json
import sys

import numpy as np


def main():
    with open(sys.argv[1]) as f:
        w = json.loads(f.readline())["bl99_coupled_witness"]
    r = w["first_non_finite_flux"]
    dt = {"f32": np.float32, "f64": np.float64}[w["dtype"]]
    meta = np.asarray(r["meta"])
    col, stride, parent = meta
    t2 = sum(n for _, n, _ in r["out2d"])
    names = {}
    for name, n, o in r["out2d"]:
        for c in range(n):
            names[o + c] = f"{name}[{c}]"
    wq = np.asarray(r["wq"], dt)
    out = {}
    for order in ("column_to_root", "root_to_column"):
        found = []
        for i, e in enumerate(r["edges"]):
            rows = np.asarray(r["table_rows"][i], dt)      # [S, F]
            area = np.asarray(r["area"][i], dt)
            xq, yq = (np.asarray(r[k][i], dt) for k in ("xq", "yq"))
            acc = np.zeros(t2, dt)
            with np.errstate(all="ignore"):
                for s in range(area.shape[0]):
                    if area[s] == 0:
                        continue
                    for o in range(t2):
                        chain = []
                        k = o
                        while k >= 0:
                            chain.append(k)
                            k = parent[k]
                        if order == "root_to_column":
                            chain = chain[::-1]
                        v = np.ones(6, dt)
                        factors = []
                        for k in chain:
                            c, st = col[k], stride[k]
                            lin = rows[s, c] + rows[s, c + st] * xq[s] + \
                                rows[s, c + 2 * st] * yq[s]
                            factors.append(lin)
                            v = v * lin
                        acc[o] += dt((wq * v).sum()) * area[s]
                        bad = ~np.isfinite(v)
                        if bad.any() and not any(
                                f["column"] == names[o] for f in found):
                            q = int(np.argmax(bad))
                            found.append({
                                "edge": e, "slot": s, "column": names[o],
                                "factors_at_point": [
                                    [names[k], float(fa[q])]
                                    for k, fa in zip(chain, factors)]})
                acc = acc * dt(r["mask_edge"][i])
            for o in np.nonzero(~np.isfinite(acc))[0]:
                name, c = names[o].split("[")
                c = int(c[:-1])
                found.append({"edge": e, "column": names[o],
                              "replayed": float(acc[o]),
                              "k2_on_the_card": r["k2"].get(name, [[None] *
                                                                   9] * 4)
                              [i][c],
                              "plain_on_the_card": r["plain"].get(
                                  name, [[None] * 9] * 4)[i][c]})
        out[order] = found
    print(json.dumps({"edges": r["edges"], "tracers": r["tracers"],
                      **out}), flush=True)


if __name__ == "__main__":
    main()
