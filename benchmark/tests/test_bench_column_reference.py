"""The column reference (`benchmark/reference/column*.py`, `ridging.py`)
against the program's column, phase by phase on seeded columns and over
whole steps of the configuration `qu60_standard_physics` through `Side`,
on the CPU in float64 at subdivision 2.

Tolerances: where both sides take the same arithmetic in another order,
float64 rounding (1e-9 relative, a thousand roundings of the step's
chains); where a Picard iterate stops at the convergence test, the test's
own size, DT_ERRMAX = 5e-4 C on a temperature (the two sides stop at the
same iterate here, so the readings are rounding too)."""

import pytest
import torch

from benchmark.harness.compare import Mapping, numbers, to_numpy
from benchmark.harness.manifest import Cell
from benchmark.harness.sides import Side, reference_side
from benchmark.reference import (column, column_itd, column_shortwave,
                                 column_thermo, column_vertical)
from benchmark import column_faults

from .small import SMALL

F64 = torch.float64
ROUNDING = 1e-9           # float64, relative to the field's size
CELL = "qu60_standard_physics.winter"
SEED = 2200000041


def rel(a, b):
    a, b = torch.as_tensor(a, dtype=F64), torch.as_tensor(b, dtype=F64)
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


@pytest.fixture(scope="module")
def sides():
    """The program's Side and the reference, float64, subdivision 2, one
    step taken (the program's state then holds growth, snow and a first
    thickness distribution)."""
    cell = Cell(CELL)
    cell.apply({**SMALL, "config": dict(SMALL["config"], dtype="float64")})
    prog = Side(cell.config, cell.traffic, SEED, "cpu", F64)
    ref = reference_side(cell.config, cell.traffic, SEED, "cpu")
    prog.step()
    return cell, prog, ref, Mapping(prog.mesh, ref.mesh)


def columns(prog):
    """The program's category state and the step's forcing, as tensors of
    the program's mesh."""
    col = prog.column
    i = prog.n_steps % col["inputs"].per_day
    return (dict(prog.state.tracers), col["atmos"][i], col["ocean"],
            col["coszen"][i])


def seeded(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return lambda: torch.rand(shape, generator=g, dtype=F64)


@pytest.mark.parametrize("sun", [True, False])
def test_dedd_shortwave(sides, sun):
    """dEdd at the step's sun (the south's caps lit) and with the sun set
    (no absorption anywhere), with ponds on a third of the categories."""
    from seaice_tpu_torch.column.dedd import shortwave_dedd
    _, prog, _, _ = sides
    tr, atm, _, coszen = columns(prog)
    r = seeded(tr["iceAreaCategory"].shape)
    apnd = 0.3 * r() * (r() > 0.66)
    hpnd = 0.3 * r()
    a, v, s = (tr[k] for k in ("iceAreaCategory", "iceVolumeCategory",
                               "snowVolumeCategory"))
    bands = {k: getattr(atm, k) for k in ("sw_vis_dir", "sw_vis_dif",
                                          "sw_ir_dir", "sw_ir_dif")}
    assert float(bands["sw_vis_dir"].max()) > 10.0
    if not sun:
        coszen = torch.zeros_like(coszen)
        bands = {k: torch.zeros_like(b) for k, b in bands.items()}
    p = shortwave_dedd(a, v, s, tr["surfaceTemperature"], coszen,
                       *bands.values(), 7, 1, apnd=apnd, hpnd=hpnd)
    q = column_shortwave.shortwave(a, v, s, tr["surfaceTemperature"], coszen,
                                   bands, apnd, hpnd, 7, 1)
    for k in ("fswsfc", "fswint", "fswthru", "Iswabs", "Sswabs"):
        got, want = getattr(p, k), q[k]
        if sun:
            assert rel(got, want) < ROUNDING, k
        else:
            assert float(want.abs().max()) == 0.0 == float(got.abs().max())


def test_mushy_vertical(sides):
    """The mushy heat solve, flooding and growth and melt of every
    category against the program's thermo_vertical, from the shortwave
    and boundary layer of the step."""
    from seaice_tpu_torch.column.vertical import thermo_vertical
    _, prog, ref, _ = sides
    tr, atm, ocn, coszen = columns(prog)
    a, v, s = (tr[k] for k in ("iceAreaCategory", "iceVolumeCategory",
                               "snowVolumeCategory"))
    bands = {k: getattr(atm, k) for k in ("sw_vis_dir", "sw_vis_dif",
                                          "sw_ir_dir", "sw_ir_dif")}
    zero = torch.zeros_like(a)
    sw = column_shortwave.shortwave(a, v, s, tr["surfaceTemperature"], coszen,
                                    bands, zero, zero, 7, 1)

    def cat(x):
        return x[:, None].expand_as(a)

    wind = torch.sqrt(atm.u_air ** 2 + atm.v_air ** 2)
    sh, lh = column_vertical.boundary_layer(
        tr["surfaceTemperature"], cat(atm.air_temperature), cat(wind),
        cat(atm.air_level_height), cat(atm.specific_humidity),
        cat(atm.air_density))
    fbot = torch.where(a > column.PUNY, -2.0, 0.0)
    p = thermo_vertical(
        1800.0, a, v, s, tr["surfaceTemperature"], tr["iceEnthalpy"],
        tr["snowEnthalpy"], tr["iceSalinity"], flw=cat(atm.longwave_down),
        potT=cat(atm.air_temperature), Qa=cat(atm.specific_humidity),
        rhoa=cat(atm.air_density), fsnow=cat(atm.snow_rate), fbot=fbot,
        Tbot=cat(ocn.freezing_temperature), fswsfc=sw["fswsfc"],
        fswint=sw["fswint"], Sswabs=sw["Sswabs"], Iswabs=sw["Iswabs"],
        shcoef=sh, lhcoef=lh, ktherm=2, sss=cat(ocn.sss))
    q = column_vertical.vertical(
        1800.0, a, v, s, tr["surfaceTemperature"], tr["iceEnthalpy"],
        tr["snowEnthalpy"], tr["iceSalinity"],
        (cat(atm.air_temperature), cat(atm.specific_humidity),
         cat(atm.air_density), cat(atm.longwave_down)),
        cat(atm.snow_rate), fbot, cat(ocn.freezing_temperature),
        cat(ocn.sss), sw, sh, lh, zero, zero)
    assert bool((~q["unconverged"]).all()) and bool(p.converged.all())
    for k in ("Tsf", "hin", "hsn", "zqin", "zqsn", "zSin"):
        assert rel(getattr(p, k), q[k]) < ROUNDING, k


def test_level_ponds_under_melt():
    """Level-ice ponds with melt, rain, freezing lids and melting lids on
    seeded categories."""
    from seaice_tpu_torch.column.ponds import compute_ponds_lvl
    r = seeded((400, 5), 1)
    a = 0.2 * r()
    v = a * (0.005 + 1.5 * r())
    s = a * 0.05 * r()
    melt = r() > 0.4
    args = (0.15 + 0.7 * a, 0.003 * r() * melt, 0.002 * r() * melt,
            1e-5 * r(), 255.0 + 22.0 * r(), 60.0 * (r() - 0.3),
            0.001 * (r() - 0.5), a, v, s)
    alvl, apnd = 0.5 + 0.5 * r(), r() * (r() > 0.5)
    hpnd, ipnd = 0.2 * r() * (apnd > 0), 0.02 * r() * (r() > 0.5)
    p = compute_ponds_lvl(1800.0, *args, None, None, None, alvl, apnd, hpnd,
                          ipnd, ktherm=2)
    q = column_thermo.level_ponds(1800.0, *args, alvl, apnd, hpnd, ipnd)
    assert float(q[0].max()) > 0.1        # ponds there are
    for got, want in zip(p[:3], q):
        assert rel(got, want) < ROUNDING


def test_rothrock_strength(sides):
    from seaice_tpu_torch.column.itd import ice_strength_rothrock
    _, prog, _, _ = sides
    a, v = (prog.state.tracers[k] for k in ("iceAreaCategory",
                                            "iceVolumeCategory"))
    aice = a.sum(-1)
    p = ice_strength_rothrock(a, v, aice, (1.0 - aice).clamp(min=0.0),
                              column.category_bounds(5))
    assert float(p.max()) > 1e3
    assert rel(p, column_itd.rothrock_strength(a, v)) < ROUNDING


def _groups(tr):
    return [{k: tr[k] for k in names} for names in
            (column.AREA_TRACERS, column.ICE_TRACERS, column.SNOW_TRACERS)]


def test_ridging(sides):
    """Three passes of ridging under convergence and shear of up to a
    tenth of the ice a step."""
    from seaice_tpu_torch.column.ridging import ridge_ice
    _, prog, _, _ = sides
    tr = dict(prog.state.tracers)
    r = seeded(tr["iceAreaCategory"].shape[:1], 2)
    conv, shear = 5e-5 * r(), 5e-5 * r()
    hin_max = column.category_bounds(5)
    a, v, s = (tr[k] for k in ("iceAreaCategory", "iceVolumeCategory",
                               "snowVolumeCategory"))
    p = ridge_ice(1800.0, hin_max, conv, shear, a, v, s, *_groups(tr))
    q = column_itd.ridge(1800.0, hin_max, conv, shear, a, v, s, *_groups(tr))
    assert rel(p.aicen[:, 4], a[:, 4]) > 1e-3          # ridges formed
    for got, want in zip((p.aicen, p.vicen, p.vsnon), q[:3]):
        assert rel(got, want) < ROUNDING
    for pg, qg in zip((p.area_tracers, p.ice_tracers, p.snow_tracers),
                      q[3:]):
        for k in qg:
            assert rel(pg[k], qg[k]) < ROUNDING, k


def test_itd_remap(sides):
    """The linear remapping after a seeded growth and melt of up to 30
    cm, with each category's tracers."""
    from seaice_tpu_torch.column.itd import linear_itd_remap
    _, prog, _, _ = sides
    tr = dict(prog.state.tracers)
    a, v, s = (tr[k] for k in ("iceAreaCategory", "iceVolumeCategory",
                               "snowVolumeCategory"))
    r = seeded(a.shape, 3)
    v2 = (v + a * 0.3 * (r() - 0.5)).clamp(min=0.0)
    hin_max = column.category_bounds(5)
    p = linear_itd_remap(hin_max, a, v, a, v2, s, *_groups(tr))
    q = column_itd.linear_remap(hin_max, a, v, a, v2, s, *_groups(tr))
    assert rel(p[0][:, 1:], a[:, 1:]) > 1e-3          # ice moved
    for got, want in zip(p[:3], q[:3]):
        assert rel(got, want) < ROUNDING
    for pg, qg in zip(p[3:], q[3:]):
        for k in qg:
            assert rel(pg[k], qg[k]) < ROUNDING, k


def step_numbers(cell, prog, ref, to_ref, fault=None):
    """The comparison's numbers of one step of the program (broken inside
    `fault`) against the reference from the same state."""
    pre = to_numpy(prog.snapshot())
    if fault is None:
        prog.step()
    else:
        with fault():
            prog.step()
    post = to_ref(to_numpy(prog.snapshot()))
    prog.load(pre)
    ref.load(to_ref(pre))
    ref.step()
    return {k: v for k, (v, _) in numbers(
        post, to_numpy(ref.state), cell.limits["amounts"],
        to_ref(pre)).items()}


def test_whole_step_agrees_in_float64(sides):
    """A step of the configuration through `Side` against the reference:
    every compared group agrees to float64 rounding of the step's long
    chains (the velocity to the reference's own discretisation, as in
    the dynamical core's cell)."""
    cell, prog, ref, to_ref = sides
    got = step_numbers(cell, prog, ref, to_ref)
    assert got["velocity.state_gap"] < 5e-6
    for g in ("ice", "column"):
        assert got[f"{g}.state_gap"] < 1e-7, g
        assert got[f"{g}.increment_gap"] < 1e-4, g


def test_planted_column_faults_fail_the_step(sides):
    """The shortwave's absorption zeroed fails the ice's limits; the
    Picard solve stopped after 2 iterations leaves columns unconverged,
    which the state check flags (its state stays within the Picard
    tolerance of the sound one)."""
    cell, prog, ref, to_ref = sides
    limits = cell.limits["limits"]
    got = step_numbers(cell, prog, ref, to_ref,
                       column_faults.shortwave_zeroed)
    assert got["ice.state_gap"] > limits["ice.state_gap"]
    assert got["ice.increment_gap"] > limits["ice.increment_gap"]
    pre = to_numpy(prog.snapshot())
    with column_faults.picard_cut_short(2):
        prog.step()
    flags = prog.check()
    prog.load(pre)
    assert not flags["column_thermo_unconverged"]
