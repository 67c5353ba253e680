"""The mushy heat solve in float32 on the columns that it left unconverged
on the QU60 sphere (the standard column physics under the winter caps'
forcing, seeds 4142135623 and 11 on an H100; `dev/column_f32_witness.py`
wrote their inputs, `tests/data/qu60_f32_unconverged_columns.npz`).

There the Picard iterates had settled to float32's rounding (changes of
1e-5 C, far under DT_ERRMAX) while the energy closure stayed at 0.35 W
m-2 against its tolerance of 0.095 for all 100 iterations: the
delta-Eddington layer coefficients, whose terms cancel near the particular
solution's singularity at lm mu = 1, held no digit in float32, so the
layers' absorbed shortwave (Iswabs, clamped at 0) no longer summed to the
interior's (fswint).  With those coefficients evaluated in float64
(`column/dedd.py::solve_dedd_column`; a no-op for a float64 state), the
float32 solve converges on those columns in 2 iterations.  The port's
step in float32 and in float64 is held against `seaice_tpu`'s column step
in float64 on the same inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu import config as JC
from seaice_tpu.column import driver as JD
from seaice_tpu.mesh import icosahedral_mesh as jicos
from seaice_tpu.model import SeaIceModel as JModel
from seaice_tpu_torch import config as C
from seaice_tpu_torch.column.driver import AtmosForcing, OceanForcing
from seaice_tpu_torch.model import build_column_physics

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "qu60_f32_unconverged_columns.npz")
FIELDS = ("iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory",
          "iceEnthalpy", "snowEnthalpy", "iceSalinity")


def _cfg(M):
    return M.Config(run=M.RunConfig(dt=1800.0), column=M.ColumnConfig(
        ktherm=2, shortwave="dEdd", pond_scheme="lvl", use_level_ice=True,
        use_ice_age=True, use_first_year_ice=True))


CFG = _cfg(C)


def cases():
    with np.load(DATA) as z:
        d = {k: z[k] for k in z.files}
    seeds = sorted(set(d["seed"].tolist()))
    return d, seeds


def _parts(d, rows, conv):
    def part(prefix):
        return {k[len(prefix):]: conv(v[rows]) for k, v in d.items()
                if k.startswith(prefix)}
    return part("tracer_"), part("atmos_"), part("ocean_")


def thermo(d, rows, dtype):
    tr, atm, ocn = _parts(d, rows, lambda a: torch.as_tensor(a).to(dtype))
    phys = build_column_physics(CFG, dtype, torch.device("cpu"))
    return phys.step_thermodynamics(
        CFG.run.dt, tr, AtmosForcing(**atm), OceanForcing(**ocn),
        coszen=torch.as_tensor(d["coszen"][rows]).to(dtype),
        day_of_year=int(d["day_of_year"][rows][0]),
        lat=torch.as_tensor(d["lat"][rows]).to(dtype))


def reference(d, rows):
    """`seaice_tpu`'s column step of the same columns, float64: the
    column physics of its `SeaIceModel` under the same configuration."""
    jm = JModel(jicos(1), _cfg(JC), dtype=jnp.float64,
                build_unstructured=False)
    tr, atm, ocn = _parts(d, rows, jnp.asarray)
    tr1, fl = jm.column.step_thermodynamics(
        jm.cfg.run.dt, tr, JD.AtmosForcing(**atm), JD.OceanForcing(**ocn),
        coszen=jnp.asarray(d["coszen"][rows]),
        day_of_year=int(d["day_of_year"][rows][0]),
        lat=jnp.asarray(d["lat"][rows]))
    assert not bool(np.asarray(fl.warnings["thermo_unconverged"]).any())
    return {k: np.asarray(v) for k, v in tr1.items()}


@pytest.mark.parametrize("seed", [4142135623, 11])
def test_f32_solve_converges_on_the_flagged_columns(seed):
    d, seeds = cases()
    assert seed in seeds
    rows = d["seed"] == seed
    assert d["flags"][rows].any()            # flagged on the card
    tr32, f32 = thermo(d, rows, torch.float32)
    tr64, f64 = thermo(d, rows, torch.float64)
    assert not bool(f32.warnings["thermo_unconverged"].any())
    assert not bool(f64.warnings["thermo_unconverged"].any())
    ref = reference(d, rows)
    # against seaice_tpu in float64: a step's rounding in float32 (the
    # enthalpies' 3e8 J m-3 hold 1e-7 of relative precision; the step's
    # chains of a few hundred operations keep them within 1e-5)
    for got in (tr32, tr64):
        for k in FIELDS:
            a, b = got[k].double().numpy(), ref[k]
            assert float(np.abs(a - b).max()) <= \
                1e-5 * float(np.abs(b).max()), k
        assert float(np.abs(got["surfaceTemperature"].double().numpy() -
                            ref["surfaceTemperature"]).max()) < 1e-3


def test_near_infrared_column_float32_near_the_singularity():
    """`dedd.solve_dedd_column` in float32 against float64 on a column lit
    where the near-infrared bands meet the singularity: the interior ice
    of band 1 (w 0.7223, g 0.94: lm 1.4295 after the delta scaling) at a
    refracted direct beam 1 - lm mu0n from 1e-8 to 1e-2 (a sun near
    coszen 0.352, which a sunlit day crosses), under band 2's surface
    layer (w 0.9088: lm 1.0137, 2.9e-3 from the first Gaussian angle in
    every column).  Every layer's absorption and the albedos within 1e-6
    of float64 (float32's rounding through the adding recurrences),
    where the layer coefficients in float32 are off by up to 1."""
    from seaice_tpu_torch.column import dedd
    n = 64
    rng = np.random.default_rng(5)
    g = 0.94
    f = g * g
    ws = (1.0 - f) * 0.7223 / (1.0 - 0.7223 * f)
    lm = np.sqrt(3.0 * (1.0 - ws) * (1.0 - ws * (g - f) / (1.0 - f)))
    d = 10.0 ** rng.uniform(-8.0, -2.0, n) * rng.choice([-1.0, 1.0], n)
    mu0n = (1.0 - d) / lm
    coszen = np.sqrt(1.0 - (1.0 - mu0n ** 2) * dedd.REFINDX ** 2)

    def run(dtype):
        def col(v):
            return torch.full((n,), v, dtype=torch.float64).to(dtype)
        return dedd.solve_dedd_column(
            [col(0.5), col(2.0), col(8.0), col(30.0)],
            [col(0.9088), col(0.7223), col(0.7223), col(0.7223)],
            [col(g)] * 4, torch.as_tensor(coszen).to(dtype), 0,
            0.06, 0.06)
    got, ref = run(torch.float32), run(torch.float64)
    for k in ("albedo_dr", "albedo_df", "abs_dir", "abs_dif"):
        pairs = zip(got[k], ref[k]) if isinstance(got[k], list) else \
            [(got[k], ref[k])]
        for a, b in pairs:
            assert torch.isfinite(a).all(), k
            assert float((a.double() - b).abs().max()) < 1e-6, k
