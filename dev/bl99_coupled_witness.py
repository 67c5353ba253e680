#!/usr/bin/env python3
"""The readings behind ROADMAP Queue 3's BL99 faults on the card: the
full-physics panel sphere at full width through `CoupledDriver`
(`chip_smoke.coupled_imports`, the per-category fluxes of
`chip_smoke.prescribed_flux_imports`, intervals of
`chip_smoke.COUPLING_INTERVAL`), with each column configuration given.
After every substep: its host-clock ms, the thermo iterations, and the
tracers that are no longer finite.  At the first substep that leaves a
non-finite tracer, the substep is taken again from its input with the
column phases checked one by one, their inputs and their outputs
(`step_thermodynamics`, `ice_strength`, `step_ridging`,
`step_post_dynamics`: a phase whose input is already non-finite names
the dynamics and transport before it), and the input state of the first
cells it spoils is printed.  --plain-flux takes the remap's plain flux
integration (`remap.integrate_fluxes`) in place of K2; --compare-flux
records the first K2 call that leaves a non-finite flux: at up to 4 of
its edges the fluxes of K2 and of the plain version, and K2's inputs
there (slot cells, areas, quadrature points, the table rows of the slot
cells, the column layout) for `dev/replay_k2_edges.py`.

    python3 dev/bl99_coupled_witness.py [--substeps 8] [--dtype f32|f64]
        [--plain-flux | --compare-flux] [--config "ktherm=1" ...]

One JSON line per configuration, then the card
(`nvidia-smi --query-gpu=name,power.limit`).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def non_finite(tracers):
    import torch
    return {k: int((~torch.isfinite(v)).sum()) for k, v in tracers.items()
            if not bool(torch.isfinite(v).all())}


def parse(text):
    """'ktherm=1,calc_surface_temperature=False' -> dict."""
    out = {}
    for item in filter(None, text.split(",")):
        k, v = (x.strip() for x in item.split("="))
        out[k] = {"True": True, "False": False}.get(
            v, int(v) if v.lstrip("-").isdigit() else v)
    return out


def at_cells(x, cells):
    """x (a tensor, a dict of them or a number) at the given cells, as
    lists."""
    import torch
    if isinstance(x, dict):
        return {k: at_cells(v, cells) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x[cells].tolist() if x.ndim else x.item()
    return x


def phase_check(model, args, kwargs):
    """The substep again from its input with the column phases checked:
    the first phase whose input or output tracers are not finite (the
    input: "before <phase>"), with its inputs at the cells it spoils
    (`inputs`: the positional arguments after the ColumnPhysics), else
    'dynamics or transport'."""
    import torch
    column, seen = model.column, []

    def wrap(name):
        fn = getattr(column, name)

        def wrapped(*a, **kw):
            tr_in = a[0] if name == "ice_strength" else a[1]
            out = fn(*a, **kw)
            tr = out[0] if isinstance(out, tuple) else {"strength": out}
            bad = non_finite(tr_in)
            if bad and not seen:
                tr, name_seen = tr_in, "before " + name
            else:
                bad, name_seen = non_finite(tr), name
            if bad and not seen:
                spoiled = torch.zeros(tr[next(iter(bad))].shape[0],
                                      dtype=torch.bool,
                                      device=tr[next(iter(bad))].device)
                for k in bad:
                    m = ~torch.isfinite(tr[k])
                    spoiled |= m.reshape(m.shape[0], -1).any(-1)
                cells = spoiled.nonzero().flatten()[:4]
                seen.append({"phase": name_seen, "non_finite": bad,
                             "cells": cells.tolist(),
                             "inputs": [at_cells(x, cells) for x in a],
                             "outputs": at_cells(tr, cells)})
            return out
        return wrapped
    names = ("step_thermodynamics", "ice_strength", "step_ridging",
             "step_post_dynamics")
    for n in names:
        setattr(column, n, wrap(n))
    try:
        state, _ = model.make_step()(*args, **kwargs)
    finally:
        for n in names:
            delattr(column, n)
    return seen[0] if seen else {"phase": "dynamics or transport",
                                 "non_finite": non_finite(state.tracers)}


def compare_flux(record):
    """Wrap K2 so that its first call with a non-finite flux is recorded
    (see the module docstring) into the list `record`."""
    import torch
    from seaice_tpu_torch.transport import cuda_flux, remap
    k2 = cuda_flux.integrate_fluxes_cuda

    def both(tree, recon, rt, cell, xq, yq, area, mask_edge):
        got = k2(tree, recon, rt, cell, xq, yq, area, mask_edge)
        if record:
            return got
        bad = {k: (~torch.isfinite(v)).reshape(v.shape[0], -1).any(-1)
               for k, v in got.items()}
        bad = {k: m for k, m in bad.items() if bool(m.any())}
        if bad:
            plain = remap.integrate_fluxes(tree, recon, rt, cell, xq, yq,
                                           area, mask_edge)
            any_bad = torch.stack(list(bad.values())).any(0)
            edges = any_bad.nonzero().flatten()[:4]
            meta, out2d, out3d = cuda_flux.flux_layout(tree, recon)
            record.append({
                "edges": edges.tolist(), "tracers": sorted(bad),
                "k2": {k: got[k][edges].tolist() for k in bad},
                "plain": {k: plain[k][edges].tolist() for k in bad},
                "cells": cell[edges].tolist(),
                "area": area[edges].tolist(), "xq": xq[edges].tolist(),
                "yq": yq[edges].tolist(),
                "mask_edge": mask_edge[edges].tolist(),
                "wq": rt.qp_weights.tolist(),
                "table_rows": cuda_flux.linear_table(
                    tree, recon)[cell[edges]].tolist(),
                "meta": meta.tolist(), "out2d": out2d, "out3d": out3d})
        return got
    cuda_flux.integrate_fluxes_cuda = both


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--substeps", type=int, default=8)
    ap.add_argument("--dtype", default="f32", choices=("f32", "f64"))
    ap.add_argument("--plain-flux", action="store_true")
    ap.add_argument("--compare-flux", action="store_true")
    ap.add_argument("--config", action="append")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("bl99_coupled_witness: no CUDA device", file=sys.stderr)
        sys.exit(2)
    card = cs.card_line()
    from seaice_tpu_torch.coupled import CoupledDriver
    from seaice_tpu_torch.kernels import build
    build.build_cuda()
    build.get_native_stencil_lib()
    if args.plain_flux:
        from seaice_tpu_torch.transport import cuda_flux, remap
        cuda_flux.integrate_fluxes_cuda = remap.integrate_fluxes
    flux_record = []
    if args.compare_flux:
        compare_flux(flux_record)
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    base = cs.full_physics_case(cs.SUBDIV, cs.N_CATEGORIES, cs.N_ICE_LAYERS,
                                cs.N_SUBCYCLES, dtype, None)[0]
    nc, ncat = base.mesh.n_cells, base.cfg.run.n_categories
    fields = dict(cs.coupled_imports(nc), **cs.prescribed_flux_imports(
        nc, ncat))
    for text in args.config or ["ktherm=1"]:
        model = base.with_column(**parse(text))
        flux_record.clear()
        drv = CoupledDriver(model, cs.full_physics_inputs(model)[0],
                            coupling_interval=cs.COUPLING_INTERVAL)
        inner, rows, first = drv.step_fn, [], []

        def checked(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            fl = out[1]["column_fluxes"]
            bad = non_finite(out[0].tracers)
            rows.append({"ms": 1e3 * (time.perf_counter() - t0),
                         "thermo_iterations": fl.thermo_iterations,
                         "thermo_unconverged": int(
                             fl.warnings["thermo_unconverged"].sum()),
                         "non_finite": bad})
            if bad and not first:
                tr_in = a[1].tracers
                where = None
                for k in bad:
                    m = ~torch.isfinite(out[0].tracers[k])
                    while m.ndim > 1:
                        m = m.any(-1)
                    where = m.nonzero().flatten()[:4]
                    break
                cells = []
                for c in where.tolist():
                    cells.append({
                        "cell": c,
                        "lat_deg": float(np.rad2deg(model.mesh.lat_cell[c])),
                        "area": tr_in["iceAreaCategory"][c].tolist(),
                        "volume": tr_in["iceVolumeCategory"][c].tolist(),
                        "snow": tr_in["snowVolumeCategory"][c].tolist(),
                        "Tsfc": tr_in["surfaceTemperature"][c].tolist()})
                first.append({"substep": len(rows),
                              "cells": cells,
                              **phase_check(model, a, kw)})
            return out
        drv.step_fn = checked
        error = None
        while len(rows) < args.substeps and error is None:
            try:
                drv.advance(fields)
            except Exception as e:      # the driver's state check
                error = f"{type(e).__name__}: {e}"
        cs.emit({"bl99_coupled_witness": {
            "config": text, "dtype": args.dtype, "card": card,
            "flux": "plain" if args.plain_flux else "K2",
            "substeps": rows, "first_non_finite": first[0] if first
            else None, "driver_error": error,
            "first_non_finite_flux": flux_record[0] if flux_record
            else None}})
        del model, drv
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
