"""The column's pond and radiation options in the port: CESM and
topographic melt ponds, the snow-liquid routing into the ponds, the pond
freshwater feedback, the SNICAR 5-band shortwave, and bulk and modal
aerosols.

Part 1 holds each ported function against the JAX package's on the same
inputs (made from a seed with numpy), float64 on the CPU, every output
to LIMIT of its own max (`tests/test_torch_column_functions.py::_compare`).
Part 2 ports the JAX package's own tests of these options
(`tests/test_pond_options.py`, `tests/test_column.py::TestTopoPonds` and
`::test_aerosol_conservation`, `tests/test_snicar.py`,
`tests/test_modal_aero.py`) to the port alone.  The two-step models
against `seaice_tpu` are in `tests/test_torch_column_model.py`, the
flag test in `tests/test_torch_column_options.py`."""

import jax
import numpy as np
import pytest
import torch

from seaice_tpu import column as J
from seaice_tpu.column import aerosol as _ja, snicar as _js  # noqa: F401
from seaice_tpu_torch import column as T
from seaice_tpu_torch.column import aerosol, dedd, ponds, snicar
from seaice_tpu_torch.column import constants as c
from seaice_tpu_torch.column.driver import (AtmosForcing, ColumnPhysics,
                                            OceanForcing)
from seaice_tpu_torch.column.thermo_shared import (
    ice_enthalpy_from_temperature, melting_temperature, salinity_profile,
    snow_enthalpy_from_temperature)
from tests.test_torch_column_functions import (NB, NS, NI, _both,
                                               _compare, _forcing, _state,
                                               _sw_inputs)

torch.set_num_threads(1)

F64 = torch.float64
LIMIT = 1e-12


# -- part 1: functions against seaice_tpu -----------------------------------

def _pond_inputs(rng):
    s = _state(rng)
    f = _forcing(rng)
    shp = s["aicen"].shape
    return dict(
        aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
        qin=s["qin"], sin=s["sin"], tsfc=s["tsfc"],
        rfrac=0.15 + 0.7 * s["aicen"],
        meltt=rng.uniform(0.0, 0.02, shp) * (rng.random(shp) < 0.6),
        melts=rng.uniform(0.0, 0.01, shp) * (rng.random(shp) < 0.4),
        frain=rng.uniform(0.0, 1e-5, shp),
        meltsliq=rng.uniform(0.0, 5.0, shp) * (rng.random(shp) < 0.5),
        Tair=f["potT"][:, None] * np.ones(shp),
        fsurfn=rng.uniform(-50.0, 100.0, shp),
        dhs=rng.uniform(-0.01, 0.01, shp),
        alvl=rng.uniform(0.3, 1.0, shp),
        apnd=rng.uniform(0.0, 0.6, shp),
        hpnd=rng.uniform(0.0, 0.4, shp) * (rng.random(shp) < 0.6),
        ipnd=rng.uniform(0.0, 0.1, shp) * (rng.random(shp) < 0.5),
        meltt_cell=rng.uniform(0.0, 0.01, NB),
        fsurf_cell=rng.uniform(-80.0, 80.0, NB))


def case_ponds(y, m):
    p = m.ponds
    cesm = ("rfrac meltt melts frain aicen vicen vsnon tsfc apnd "
            "hpnd").split()
    lvl = ("rfrac meltt melts frain Tair fsurfn dhs aicen vicen vsnon qin "
           "sin tsfc alvl apnd hpnd ipnd").split()
    topo = ("aicen vicen vsnon meltt_cell fsurf_cell tsfc qin sin apnd "
            "hpnd ipnd").split()
    return dict(
        cesm=p.compute_ponds_cesm(1800.0, *(y[k] for k in cesm)),
        cesm_sliq=p.compute_ponds_cesm(1800.0, *(y[k] for k in cesm),
                                       pndaspect=0.6,
                                       meltsliq=y["meltsliq"]),
        lvl_sliq=p.compute_ponds_lvl(1800.0, *(y[k] for k in lvl),
                                     meltsliq=y["meltsliq"]),
        topo1=p.compute_ponds_topo(1800.0, *(y[k] for k in topo)),
        topo2=p.compute_ponds_topo(1800.0, *(y[k] for k in topo), ktherm=2),
        perm=p.permeability_phi_topo(y["qin"] - 1.0, y["sin"] + 0.1))


def _aerosol_inputs(rng, n_aero=3):
    s = _state(rng)
    shp = s["aicen"].shape
    return dict(
        aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
        aero=rng.uniform(0.0, 1e-6, shp + (n_aero, 4)),
        melts=rng.uniform(0.0, 0.05, shp) * (rng.random(shp) < 0.5),
        meltt=rng.uniform(0.0, 0.05, shp) * (rng.random(shp) < 0.5),
        meltb=rng.uniform(0.0, 0.05, shp) * (rng.random(shp) < 0.5),
        congel=rng.uniform(0.0, 0.01, shp),
        snoice=rng.uniform(0.0, 0.01, shp) * (rng.random(shp) < 0.3),
        hsn_new=rng.uniform(0.0, 0.01, shp),
        faero_atm=rng.uniform(0.0, 1e-11, (NB, n_aero)))


def case_aerosol(y, m):
    keys = ("aero aicen vicen vsnon melts meltt meltb congel snoice "
            "hsn_new faero_atm").split()
    return m.aerosol.update_aerosol(1800.0, *(y[k] for k in keys))


def _shortwave_inputs(rng, n_aero=3):
    _, x = _sw_inputs(rng)
    shp = x["aicen"].shape
    x.update(aero_snow=rng.uniform(0.0, 5e-5, shp + (n_aero, 2)),
             aero_ice=rng.uniform(0.0, 1e-4, shp + (n_aero, 2)),
             rsnw=rng.uniform(20.0, 1700.0, shp + (NS,)))
    return x


def case_dedd_aerosols(y, m):
    args = (y["aicen"], y["vicen"], y["vsnon"], y["tsfc"], y["coszen"],
            *y["sw"], NI, NS)
    return dict(
        bulk=m.dedd.shortwave_dedd(
            *args, apnd=y["apnd"] * y["alvl"], hpnd=y["hpnd"],
            aero_mp_snow=y["aero_snow"], aero_mp_ice=y["aero_ice"]),
        modal=m.dedd.shortwave_dedd(
            *args, rsnw=y["rsnw"], aero_mp_snow=y["aero_snow"],
            aero_mp_ice=y["aero_ice"], modal_aero=True),
        bins=m.dedd._snow_grain_bcenh_index(y["rsnw"]))


def case_snicar(y, m):
    args = (y["aicen"], y["vicen"], y["vsnon"], y["tsfc"], y["coszen"],
            *y["sw"], NI, NS)
    s = m.snicar
    tables = () if m is J else (s.snicar_tables(F64, "cpu"),)
    return dict(
        ponds_aero=s.shortwave_snicar(
            *args, apnd=y["apnd"], hpnd=y["hpnd"], rsnw=y["rsnw"],
            aero_mp_snow=y["aero_snow"], aero_mp_ice=y["aero_ice"],
            R_ice=0.3, R_pnd=-0.2),
        ssp=[s.snow_ssp(y["rsnw"][..., 0], b, k, *tables)
             for b in range(5) for k in range(2)])


FUNCTIONS = {"ponds": (_pond_inputs, case_ponds),
             "aerosol": (_aerosol_inputs, case_aerosol),
             "dedd_aerosols": (_shortwave_inputs, case_dedd_aerosols),
             "snicar": (_shortwave_inputs, case_snicar)}
# reference calls that compile faster as one jitted program than they
# dispatch op by op (the shortwave ones do not: SNICAR's jitted compile
# takes minutes)
JIT = {"ponds", "aerosol"}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_pond_and_radiation_function_matches_reference(name):
    """compute_ponds_cesm/_topo (with and without the snow-liquid
    source), permeability_phi_topo, compute_ponds_lvl's snow-liquid
    source, update_aerosol, dEdd with bulk and modal aerosols, the
    snow-grain bins of the BC enhancement, SNICAR (ponded, with a
    grain-radius tracer and aerosols) and its SSP interpolation: every
    output to LIMIT (integer bins equal).  The column driver with these
    options is held in `tests/test_torch_column_model.py`."""
    inputs, case = FUNCTIONS[name]
    a, t = _both(inputs(np.random.default_rng(sorted(FUNCTIONS).index(name)
                                              + 41)))
    ref = jax.jit(lambda y: case(y, J))(a) if name in JIT else case(a, J)
    got = case(t, T)
    if name == "dedd_aerosols":
        assert np.array_equal(np.asarray(ref.pop("bins")),
                              got.pop("bins").numpy())
    _compare(ref, got, LIMIT)


# -- part 2: the JAX package's tests of these options, on the port --------

# tests/test_pond_options.py

def test_smliq_changes_cesm_pond_answer():
    nb, ncat = 4, 1
    one = torch.ones((nb, ncat), dtype=F64)
    args = dict(dt=3600.0, rfrac=0.5 * one, meltt=0.002 * one,
                melts=0.004 * one, frain=1e-5 * one,
                aicen=0.9 * one, vicen=1.5 * one, vsnon=0.2 * one,
                Tsfcn=-0.5 * one, apnd=0.1 * one, hpnd=0.05 * one)
    a_ref, h_ref = ponds.compute_ponds_cesm(**args)
    # meltsliq twice the snow-melt mass -> bigger ponds
    msl = 2.0 * (args["melts"] * c.RHOS + args["frain"] * 3600.0)
    a_sm, h_sm = ponds.compute_ponds_cesm(**args, meltsliq=msl)
    assert float((a_sm * h_sm - a_ref * h_ref).min()) > 0.0
    # zero drained liquid -> only the top-melt source remains
    a_z, h_z = ponds.compute_ponds_cesm(**args,
                                        meltsliq=torch.zeros_like(msl))
    assert float((a_z * h_z).max()) < float((a_ref * h_ref).min())


def test_smliq_changes_lvl_pond_answer():
    nb, ncat, ni = 3, 1, 7
    one = torch.ones((nb, ncat), dtype=F64)
    qi = torch.full((nb, ncat, ni), -2.5e8, dtype=F64)
    si = torch.full((nb, ncat, ni), 3.0, dtype=F64)
    args = dict(dt=3600.0, rfrac=0.5 * one, meltt=0.002 * one,
                melts=0.004 * one, frain=1e-5 * one,
                Tair=274.0 * one, fsurfn=10.0 * one, dhs=0.0 * one,
                aicen=0.9 * one, vicen=1.5 * one, vsnon=0.0 * one,
                qicen=qi, sicen=si, Tsfcn=-0.1 * one,
                alvl=one, apnd=0.1 * one, hpnd=0.05 * one,
                ipnd=0.0 * one)
    a_ref, h_ref, _, _ = ponds.compute_ponds_lvl(**args)
    msl = 3.0 * (args["melts"] * c.RHOS + args["frain"] * 3600.0)
    a_sm, h_sm, _, _ = ponds.compute_ponds_lvl(**args, meltsliq=msl)
    assert float((a_sm * h_sm).sum()) > float((a_ref * h_ref).sum())


def _driver_melting_setup(ncat=3, nb=4, pond_scheme="topo", **colkw):
    ni, ns = 7, 1
    col = ColumnPhysics(ncat, ni, pond_scheme=pond_scheme, dtype=F64,
                        device="cpu", **colkw)
    area = torch.full((nb, ncat), 0.9 / ncat, dtype=F64)
    Sz = torch.as_tensor(salinity_profile(ni)).expand(nb, ncat, ni)
    tr = {
        "iceAreaCategory": area,
        "iceVolumeCategory": area * 1.4,
        "snowVolumeCategory": area * 0.15,
        "surfaceTemperature": torch.full((nb, ncat), -0.2, dtype=F64),
        "iceEnthalpy": ice_enthalpy_from_temperature(
            torch.full((nb, ncat, ni), -1.0, dtype=F64),
            melting_temperature(Sz)),
        "iceSalinity": Sz.clone(),
        "snowEnthalpy": snow_enthalpy_from_temperature(
            torch.full((nb, ncat, ns), -0.5, dtype=F64)),
        "pondArea": torch.full((nb, ncat), 0.2, dtype=F64),
        "pondDepth": torch.full((nb, ncat), 0.05, dtype=F64),
        "pondLidThickness": torch.zeros((nb, ncat), dtype=F64),
    }
    if colkw.get("use_snow_tracers"):
        hs = tr["snowVolumeCategory"] / area.clamp(min=1e-12)
        tr["snowIceMass"] = (0.8 * c.RHOS * hs)[..., None].expand(
            nb, ncat, ns).clone()
        tr["snowLiquidMass"] = (50.0 * hs)[..., None].expand(
            nb, ncat, ns).clone()
        tr["snowGrainRadius"] = torch.full((nb, ncat, ns), 200.0,
                                           dtype=F64)
    one = torch.ones(nb, dtype=F64)
    # strong melting forcing
    atm = AtmosForcing(
        air_temperature=278.0 * one, specific_humidity=4e-3 * one,
        u_air=4.0 * one, v_air=0.0 * one, longwave_down=320.0 * one,
        sw_vis_dir=250.0 * one, sw_vis_dif=100.0 * one,
        sw_ir_dir=200.0 * one, sw_ir_dif=80.0 * one,
        rain_rate=2e-5 * one, snow_rate=0.0 * one,
        air_density=1.3 * one, air_level_height=10.0 * one)
    ocn = OceanForcing(
        sst=-1.0 * one, sss=34.0 * one,
        freezing_temperature=-1.8 * one, frzmlt=-30.0 * one,
        mixed_layer_depth=20.0 * one)
    return col, tr, atm, ocn


def test_pond_freshwater_feedback_budget():
    """With the feedback on, the ocean freshwater flux drops by
    exactly fpond * rhofresh (the pond-retained water), everything
    else identical."""
    col_off, tr, atm, ocn = _driver_melting_setup()
    col_on, _, _, _ = _driver_melting_setup(
        include_pond_freshwater_feedback=True)
    tr_off, fl_off = col_off.step_thermodynamics(3600.0, tr, atm, ocn)
    tr_on, fl_on = col_on.step_thermodynamics(3600.0, tr, atm, ocn)
    fpond = fl_off.fpond.numpy()          # m/s of pond water
    assert np.abs(fpond).max() > 0.0, "setup must move pond water"
    np.testing.assert_allclose(
        fl_off.fresh.numpy() - fl_on.fresh.numpy(), fpond * c.RHOFRESH,
        rtol=1e-10)
    # state identical: the feedback only redirects the coupler flux
    for k in tr_off:
        assert torch.equal(tr_off[k], tr_on[k]), k


def test_snow_liquid_ponds_change_the_driver_answer():
    # cesm ponds: no capacity-limited drainage, so the pond volume
    # reflects the source water directly
    col_ref, tr, atm, ocn = _driver_melting_setup(
        pond_scheme="cesm", use_snow_tracers=True)
    col_sm, _, _, _ = _driver_melting_setup(
        pond_scheme="cesm", use_snow_tracers=True,
        use_snow_liquid_ponds=True)
    tr_ref, _ = col_ref.step_thermodynamics(3600.0, tr, atm, ocn)
    tr_sm, _ = col_sm.step_thermodynamics(3600.0, tr, atm, ocn)
    a = (tr_ref["pondDepth"] * tr_ref["pondArea"]).numpy()
    b = (tr_sm["pondDepth"] * tr_sm["pondArea"]).numpy()
    assert np.abs(a - b).max() > 1e-8
    assert np.isfinite(b).all()


def test_snow_liquid_ponds_require_snow_tracers():
    with pytest.raises(ValueError, match="snow"):
        ColumnPhysics(3, 7, pond_scheme="topo", use_snow_liquid_ponds=True,
                      device="cpu")


def test_namelist_maps_pond_options():
    from seaice_tpu_torch.namelist import config_from_namelist
    cfg, _ = config_from_namelist({
        "forcing": {"config_include_pond_freshwater_feedback": True},
        "snow": {"config_use_snow_liquid_ponds": True,
                 "config_use_effective_snow_density": True}})
    assert cfg.column.include_pond_freshwater_feedback is True
    assert cfg.column.use_snow_liquid_ponds is True


# tests/test_column.py::TestTopoPonds

def _topo_state(nb=3, ncat=5):
    ni = 7
    aicen = torch.full((nb, ncat), 0.19, dtype=F64)
    hicen = torch.tensor([0.4, 0.9, 1.6, 2.8, 4.5], dtype=F64)
    vicen = aicen * hicen
    vsnon = aicen * 0.02
    Sz = torch.as_tensor(salinity_profile(ni)).expand(nb, ncat, ni)
    qicen = ice_enthalpy_from_temperature(
        torch.full((nb, ncat, ni), -5.0, dtype=F64), melting_temperature(Sz))
    return aicen, vicen, vsnon, qicen, Sz


def _topo(*args):
    return ponds.compute_ponds_topo(3600.0, *(
        torch.as_tensor(a, dtype=F64) for a in args))


def test_topo_fill_budget_and_topography():
    nb, ncat = 3, 5
    aicen, vicen, vsnon, qicen, Sz = _topo_state(nb, ncat)
    # rows: modest pond / large pond (hits capacity) / tiny (inactive)
    apnd0 = torch.tensor([[0.3] * ncat, [0.9] * ncat, [0.0] * ncat],
                         dtype=F64)
    hpnd0 = torch.tensor([[0.05] * ncat, [3.0] * ncat, [0.0] * ncat],
                         dtype=F64)
    z = torch.zeros((nb, ncat), dtype=F64)
    apnd, hpnd, ipnd, dfpond, drain = _topo(
        aicen, vicen, vsnon, np.zeros(nb), np.full(nb, 10.0),
        np.full((nb, ncat), -5.0), qicen, Sz, apnd0, hpnd0, z)
    volp0 = (hpnd0 * apnd0 * aicen).sum(-1).numpy()
    volp1 = (hpnd * apnd * aicen).sum(-1).numpy()
    vuin1 = (ipnd * apnd * aicen).sum(-1).numpy()
    # liquid pond budget closes: final = initial + dfpond - lid
    np.testing.assert_allclose(volp1 + vuin1, volp0 + dfpond.numpy(),
                               atol=1e-10)
    assert (drain.numpy() >= 0).all()
    # row 1 overfilled -> must have drained a lot
    assert float(drain[1]) > 0.1
    # row 2 has no pond -> everything stays zero
    assert float(volp1[2]) == 0.0
    # hydrostatic levelling: pond deeper on thinner categories
    h1 = hpnd[0].numpy()
    occupied = apnd[0].numpy() > 0
    assert occupied[0], "thinnest category must pond first"
    assert not occupied[-1], "thickest category never ponds"
    assert (np.diff(h1[occupied]) <= 1e-10).all(), \
        "pond depth must decrease with floor height"


def test_topo_lid_freeze_and_melt():
    nb, ncat = 2, 5
    aicen, vicen, vsnon, qicen, Sz = _topo_state(nb, ncat)
    apnd0 = torch.full((nb, ncat), 0.4, dtype=F64)
    hpnd0 = torch.full((nb, ncat), 0.15, dtype=F64)
    # cold surface, negative surface flux -> a lid forms
    _, _, ipnd_c, _, _ = _topo(
        aicen, vicen, vsnon, np.zeros(nb), np.full(nb, -50.0),
        np.full((nb, ncat), -8.0), qicen, Sz, apnd0, hpnd0,
        np.zeros((nb, ncat)))
    assert float(ipnd_c.max()) > 0.0
    # warm surface + meltwater -> an existing lid melts back
    ip_exist = torch.full((nb, ncat), 0.05, dtype=F64)
    a1, _, ipnd_w, _, _ = _topo(
        aicen, vicen, vsnon, np.full(nb, 0.02), np.full(nb, 100.0),
        np.full((nb, ncat), -0.05), qicen, Sz, apnd0, hpnd0, ip_exist)
    lid0 = float((ip_exist * apnd0 * aicen)[0].sum())
    lid1 = float((ipnd_w * a1 * aicen)[0].sum())
    assert lid1 < lid0


def test_topo_finite():
    """The reference's `test_jit_and_finite` (jitted there): every output
    finite on a pond state of 4 cells."""
    nb, ncat = 4, 5
    aicen, vicen, vsnon, qicen, Sz = _topo_state(nb, ncat)
    out = _topo(aicen, vicen, vsnon, np.zeros(nb), np.zeros(nb),
                np.full((nb, ncat), -3.0), qicen, Sz,
                np.full((nb, ncat), 0.2), np.full((nb, ncat), 0.1),
                np.zeros((nb, ncat)))
    for v in out:
        assert bool(torch.isfinite(v).all())


# tests/test_column.py::test_aerosol_conservation

def test_aerosol_conservation():
    """Aerosol pool transfers conserve total mass (pools + ocean flux)
    (reference update_aerosol, ice_aerosol.F90)."""
    rng = np.random.RandomState(0)
    nb, ncat, na = 5, 3, 2
    aero = torch.as_tensor(rng.rand(nb, ncat, na, 4) * 1e-6)
    aicen = torch.as_tensor(0.2 + 0.1 * rng.rand(nb, ncat))
    vicen = aicen * 1.5
    vsnon = aicen * 0.15
    dt = 3600.0
    melts = torch.full((nb, ncat), 1e-3, dtype=F64)
    meltt = torch.full((nb, ncat), 5e-4, dtype=F64)
    meltb = torch.full((nb, ncat), 1e-3, dtype=F64)
    dep = torch.as_tensor(rng.rand(nb, na) * 1e-12)
    zero = torch.zeros((nb, ncat), dtype=F64)
    res = aerosol.update_aerosol(dt, aero, aicen, vicen, vsnon, melts,
                                 meltt, meltb, zero, zero, zero, dep)
    assert float(res.aero.min()) >= 0.0
    # mass balance per species: area-weighted pools + ocean flux = input
    m0 = (aero.sum(-1) * aicen[..., None]).sum(1).numpy()
    m1 = (res.aero.sum(-1) * aicen[..., None]).sum(1).numpy()
    dep_total = dep.numpy() * dt * aicen.numpy().sum(1, keepdims=True)
    np.testing.assert_allclose(m1 + res.flux_ocn.numpy() * dt,
                               m0 + dep_total, rtol=1e-10)


# tests/test_snicar.py

def _sw_forcing(nb):
    one = torch.ones(nb, dtype=F64)
    return dict(swvdr=100.0 * one, swvdf=60.0 * one, swidr=110.0 * one,
                swidf=60.0 * one)


def _reflected(sw, f):
    return (sw.alvdr * f["swvdr"][:, None] + sw.alvdf * f["swvdf"][:, None]
            + sw.alidr * f["swidr"][:, None] +
            sw.alidf * f["swidf"][:, None])


def test_snicar_energy_closure_and_ranges():
    nb = 4
    hi = torch.tensor([0.3, 2.5, 1.5, 1.5], dtype=F64)[:, None]
    hs = torch.tensor([0.0, 0.0, 0.05, 0.4], dtype=F64)[:, None]
    aicen = torch.ones((nb, 1), dtype=F64)
    f = _sw_forcing(nb)
    sw = snicar.shortwave_snicar(
        aicen, hi * aicen, hs * aicen, torch.full((nb, 1), -5.0,
                                                  dtype=F64),
        torch.full((nb,), 0.5, dtype=F64), **f, n_ice_layers=7)
    incident = sum(f.values())
    absorbed = (sw.fswsfc + sw.fswint + sw.fswthru)[:, 0]
    reflected = _reflected(sw, f)[:, 0]
    np.testing.assert_allclose((absorbed + reflected).numpy(),
                               incident.numpy(), rtol=1e-6)
    alb = (reflected / incident).numpy()
    # thin bare < thick bare < snow-covered; published SNICAR ranges
    assert alb[0] < alb[1] < alb[2] <= alb[3]
    assert 0.1 < alb[0] and 0.7 < alb[3] < 0.95
    np.testing.assert_allclose((sw.Iswabs.sum(-1) + sw.Sswabs.sum(-1)
                                ).numpy(), sw.fswint.numpy(), atol=1e-6)


def test_snicar_grain_radius_darkens_snow():
    aicen = torch.ones((1, 1), dtype=F64)
    tsf = torch.full((1, 1), -10.0, dtype=F64)
    f = _sw_forcing(1)
    incident = float(sum(f.values())[0])

    def alb(r):
        sw = snicar.shortwave_snicar(
            aicen, 1.5 * aicen, 0.3 * aicen, tsf,
            torch.full((1,), 0.5, dtype=F64), **f, n_ice_layers=7,
            rsnw=torch.full((1, 1, 1), r, dtype=F64))
        return float(_reflected(sw, f)[0, 0]) / incident

    assert alb(50.0) > alb(400.0) > alb(1500.0)
    assert 0.55 < alb(1500.0) < alb(50.0) < 0.95


def test_snicar_in_driver():
    """use_snicar reaches the radiation dispatch."""
    col = ColumnPhysics(3, 4, shortwave="dEdd", use_snicar=True,
                        use_snow_tracers=True, device="cpu")
    aicen = torch.full((2, 3), 0.3, dtype=F64)
    tracers = {"snowGrainRadius": torch.full((2, 3, 1), 120.0, dtype=F64)}
    one = torch.ones(2, dtype=F64)
    sw = col._step_radiation(aicen, aicen * 1.0, aicen * 0.2,
                             torch.full((2, 3), -5.0, dtype=F64), 0.5 * one,
                             100.0 * one, 60.0 * one, 110.0 * one,
                             60.0 * one, tracers)
    for v in sw:
        assert bool(torch.isfinite(v).all())
    assert float(sw.alvdr.max()) > 0.5      # snow-covered: bright


def test_snicar_pond_snow_blend_consistent():
    """final = base + fs*(snow5 - bare3): ponded columns reduce to the
    3-band result when snow-free, and energy still closes with ponds."""
    nb = 2
    aicen = torch.ones((nb, 1), dtype=F64)
    hi = 1.5 * aicen
    hs = torch.tensor([0.0, 0.2], dtype=F64)[:, None]
    apnd = torch.full((nb, 1), 0.4, dtype=F64)
    hpnd = torch.full((nb, 1), 0.15, dtype=F64)
    tsf = torch.full((nb, 1), -2.0, dtype=F64)
    cz = torch.full((nb,), 0.6, dtype=F64)
    f = _sw_forcing(nb)
    sw5 = snicar.shortwave_snicar(aicen, hi, hs, tsf, cz, **f,
                                  n_ice_layers=7, apnd=apnd, hpnd=hpnd)
    sw3 = dedd.shortwave_dedd(aicen, hi, torch.zeros_like(hs), tsf, cz,
                              **f, n_ice_layers=7, apnd=apnd, hpnd=hpnd)
    # snow-free column: 5-band == 3-band path exactly
    np.testing.assert_allclose(float(sw5.alvdr[0, 0]),
                               float(sw3.alvdr[0, 0]), rtol=1e-12)
    absorbed = (sw5.fswsfc + sw5.fswint + sw5.fswthru)[:, 0]
    np.testing.assert_allclose(
        (absorbed + _reflected(sw5, f)[:, 0]).numpy(),
        sum(f.values()).numpy(), rtol=1e-6)


def _sw_column(nb=3):
    a = torch.full((nb, 1), 0.9, dtype=F64)
    return (a, 1.5 * a, 0.25 * a, torch.full((nb, 1), -10.0, dtype=F64),
            torch.full((nb, 1), 0.6, dtype=F64),
            *[torch.full((nb,), 100.0, dtype=F64)] * 4)


def _mp(nb, n_sp, species, slot, value):
    mp = torch.zeros((nb, 1, n_sp, 2), dtype=F64)
    mp[..., species, slot] = value
    return mp


@pytest.mark.parametrize("case", ["bc_darkens_snow",
                                  "dust_darkens_less_than_bc",
                                  "ice_aerosol_changes_transmission"])
def test_aerosol_optics(case):
    """`tests/test_snicar.py::TestAerosolOptics`: bulk aerosol optics in
    dEdd (reference ice_shortwave.F90:2556-2650), 4 ice layers: absorbing
    aerosols darken the surface."""
    nb = 3

    def run(**kw):
        return dedd.shortwave_dedd(*_sw_column(nb), 4, 1, **kw)

    clean = run()
    if case == "bc_darkens_snow":
        # 5e-5 kg/m^2 of black carbon (species 0) in the snow SSL
        dirty = run(aero_mp_snow=_mp(nb, 1, 0, 0, 5e-5))
        assert float(dirty.alvdr.mean()) < float(clean.alvdr.mean()) - 0.01
        for f in (dirty.alvdr, dirty.alidf):
            assert bool(((f >= 0.0) & (f <= 1.0)).all())
    elif case == "dust_darkens_less_than_bc":
        a_bc = run(aero_mp_snow=_mp(nb, 3, 0, 0, 2e-5))
        a_du = run(aero_mp_snow=_mp(nb, 3, 2, 0, 2e-5))
        assert float(a_bc.alvdr.mean()) < float(a_du.alvdr.mean())
        assert float(a_du.alvdr.mean()) <= float(clean.alvdr.mean()) + 1e-12
    else:
        dirty = run(aero_mp_ice=_mp(nb, 1, 0, 1, 1e-4))  # BC in the ice body
        assert float(dirty.fswthru.mean()) < float(clean.fswthru.mean())


def test_snicar_aerosol_darkens_snow():
    """BC in the snow lowers the 5-band SNICAR albedo too."""
    nb = 2
    clean = snicar.shortwave_snicar(*_sw_column(nb), 4, 1)
    dirty = snicar.shortwave_snicar(*_sw_column(nb), 4, 1,
                                    aero_mp_snow=_mp(nb, 1, 0, 0, 5e-5))
    assert float(dirty.alvdr.mean()) < float(clean.alvdr.mean()) - 0.01
    for f in (dirty.alvdr, dirty.alidf):
        assert bool(((f >= 0.0) & (f <= 1.0)).all())


def test_snicar_tables_are_column_data():
    """The SNICAR tables and the 5-band aerosol optics live on the
    ColumnPhysics, in its dtype: installing exact 5-band optics changes
    that column's answer and leaves another column's as it was (the
    reference keeps them as module globals, `set_aerosol_optics_5bd`)."""
    def col():
        return ColumnPhysics(1, 4, shortwave="dEdd", use_snicar=True,
                             n_aerosols=1, dtype=torch.float32,
                             device="cpu")
    plain, exact = col(), col()
    assert plain.snicar.ext.dtype == torch.float32
    exact.set_aerosol_optics_5bd(*(np.full((5, 1), v)
                                   for v in (3e4, 0.2, 0.5)))
    nb = 2
    args = [x.float() for x in _sw_column(nb)]
    tr = {"snowScatteringAerosol": torch.full((nb, 1, 1), 1e-5),
          "snowBodyAerosol": torch.zeros((nb, 1, 1)),
          "iceScatteringAerosol": torch.zeros((nb, 1, 1)),
          "iceBodyAerosol": torch.zeros((nb, 1, 1))}
    a = plain._step_radiation(*args, tr)
    b = exact._step_radiation(*args, tr)
    assert a.alvdr.dtype == torch.float32
    assert float(b.alvdr.mean()) < float(a.alvdr.mean())
    assert torch.equal(col()._step_radiation(*args, tr).alvdr, a.alvdr)


# tests/test_modal_aero.py

def test_snow_grain_index_matches_reference_mapping():
    # reference: <125: nint(r/50); <175: 2; else nint(r/250+2),
    # clipped to 1..8 (returned 0-based here)
    cases = {30.0: 1, 60.0: 1, 80.0: 2, 110.0: 2, 130.0: 2,
             170.0: 2, 200.0: 3, 500.0: 4, 1000.0: 6, 1500.0: 8,
             2000.0: 8}
    for r, want_1based in cases.items():
        got = int(dedd._snow_grain_bcenh_index(torch.tensor(r))) + 1
        assert got == want_1based, (r, got, want_1based)


def test_modal_aero_darkens_more_for_within_grain_bc():
    """Within-grain BC mass must absorb MORE under the modal
    treatment (bcenh > 1 enhancement) than under the bulk tables,
    and the flag must change the answer."""
    nb, ncat = 3, 2
    one = torch.ones((nb, ncat), dtype=F64)
    f = dict(swvdr=100.0 * torch.ones(nb, dtype=F64),
             swvdf=80.0 * torch.ones(nb, dtype=F64),
             swidr=90.0 * torch.ones(nb, dtype=F64),
             swidf=60.0 * torch.ones(nb, dtype=F64))
    args = dict(aicen=0.9 * one, vicen=1.5 * one, vsnon=0.25 * one,
                Tsfcn=-5.0 * one, coszen=torch.full((nb,), 0.5, dtype=F64),
                n_ice_layers=7, **f)
    # all mass in the within-grain BC species (index 1), snow pools
    mp = torch.zeros((nb, ncat, 2, 2), dtype=F64)
    mp[..., 1, 0] = 5e-6      # within-grain BC, snow SSL pool (kg/m^2)
    mp[..., 1, 1] = 5e-6      # body pool
    aero_ice = torch.zeros_like(mp)
    modal = dedd.shortwave_dedd(**args, aero_mp_snow=mp,
                                aero_mp_ice=aero_ice, modal_aero=True)
    bulk = dedd.shortwave_dedd(**args, aero_mp_snow=mp,
                               aero_mp_ice=aero_ice, modal_aero=False)
    r_modal = float(_reflected(modal, f).sum())
    r_bulk = float(_reflected(bulk, f).sum())
    assert r_modal < r_bulk, (r_modal, r_bulk)
    # energy closure still holds in modal mode
    inc = sum(f.values())[:, None] * torch.ones_like(one)
    absorbed = modal.fswsfc + modal.fswint + modal.fswthru
    np.testing.assert_allclose((absorbed + _reflected(modal, f)).numpy(),
                               inc.numpy(), rtol=1e-5)


def test_modal_requires_dedd_and_two_species():
    with pytest.raises(ValueError, match="dEdd"):
        ColumnPhysics(3, 7, shortwave="ccsm3", n_aerosols=2,
                      use_modal_aerosols=True, device="cpu")
    with pytest.raises(ValueError, match="species"):
        ColumnPhysics(3, 7, shortwave="dEdd", n_aerosols=1,
                      use_modal_aerosols=True, device="cpu")


def test_namelist_maps_modal_aerosols():
    from seaice_tpu_torch.namelist import config_from_namelist
    cfg, _ = config_from_namelist({
        "biogeochemistry": {"config_use_modal_aerosols": True},
        "shortwave": {"config_shortwave_type": "dEdd"},
        "aerosols": {"config_use_aerosols": True}})
    assert cfg.column.use_modal_aerosols is True
