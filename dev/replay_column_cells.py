#!/usr/bin/env python3
"""Replay the column thermodynamics of the cells that the file-driven
run's float64 column flagged unconverged, in both packages, on the CPU
in float64: the inputs that `dev/file_run_witness.py` wrote on the card
(every tracer of the flagged cells, their atmosphere and ocean forcing
and coszen) go through `step_thermodynamics` of `seaice_tpu_torch` and
of `seaice_tpu` (the reference, op by op), each built from
`chip_smoke.file_config()`.  Prints, for each package, the cells and
categories its column flags and its Picard iteration count, and the
largest distance between the two packages' tracers beside the
reference's largest value.

    JAX_PLATFORMS=cpu python3 dev/replay_column_cells.py DUMP.npz
"""

import json
import os
import sys

import numpy as np


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch
    import chip_smoke as cs
    from seaice_tpu import config as JC
    from seaice_tpu.column.driver import (AtmosForcing as JAtmos,
                                          OceanForcing as JOcean)
    from seaice_tpu.mesh import icosahedral_mesh as jicos
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu_torch.column.driver import AtmosForcing, OceanForcing
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.model import SeaIceModel

    with np.load(sys.argv[1]) as z:
        d = {k: z[k] for k in z.files}
    dt = 1800.0

    def part(prefix):
        return {k[len(prefix):]: v for k, v in d.items()
                if k.startswith(prefix)}

    tracers, atm, ocn = part("tracer_"), part("atmos_"), part("ocean_")
    port = SeaIceModel(icosahedral_mesh(2), cs.file_config(),
                       dtype=torch.float64, device="cpu").column
    ref = JModel(jicos(2), cs.file_config(JC), dtype=jnp.float64).column

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    p_tr, p_fl = port.step_thermodynamics(
        dt, {k: t(v) for k, v in tracers.items()},
        AtmosForcing(**{k: t(v) for k, v in atm.items()}),
        OceanForcing(**{k: t(v) for k, v in ocn.items()}),
        coszen=t(d["coszen"]))
    j_tr, j_fl = ref.step_thermodynamics(
        dt, {k: jnp.asarray(v) for k, v in tracers.items()},
        JAtmos(**{k: jnp.asarray(v) for k, v in atm.items()}),
        JOcean(**{k: jnp.asarray(v) for k, v in ocn.items()}),
        coszen=jnp.asarray(d["coszen"]))

    def flags(fl):
        m = np.asarray(fl.warnings["thermo_unconverged"])
        return [[int(d["cell_index"][i]), int(c)]
                for i, c in zip(*np.nonzero(m.reshape(m.shape[0], -1)))]

    dist = {k: [float(np.abs(p_tr[k].numpy() - np.asarray(j_tr[k])).max()),
                float(np.abs(np.asarray(j_tr[k])).max())]
            for k in j_tr if k in p_tr}
    print(json.dumps({
        "step": int(d["step"]), "cells": d["cell_index"].tolist(),
        "lat_deg": np.rad2deg(d["lat"]).tolist(),
        "ice_area_by_category": tracers["iceAreaCategory"].tolist(),
        "flags_on_the_card": d["flags"].astype(int).tolist(),
        "port_cpu_flags": flags(p_fl),
        "reference_cpu_flags": flags(j_fl),
        "port_iterations": p_fl.thermo_iterations,
        "reference_iterations": int(np.asarray(
            getattr(j_fl, "thermo_iterations", -1))),
        "port_vs_reference_max_abs_and_reference_max": dist}), flush=True)


if __name__ == "__main__":
    main()
