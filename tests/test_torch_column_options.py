"""The column's thermodynamics, surface and snow options in the port:
zero-layer thermodynamics (ktherm=0), prescribed surface fluxes
(calc_Tsfc=False), form drag, high-frequency coupling, the snow tracers
and snow redistribution; and the flag test of the pond schemes.

Part 1 holds each ported function against the JAX package's on the same
inputs (made from a seed with numpy), float64 on the CPU, every output
to LIMIT of its own max (`tests/test_torch_column_functions.py::_compare`;
boolean masks equal).  Part 2 ports the JAX package's own tests of these
options (`tests/test_column.py`, `tests/test_calc_tsfc.py`,
`tests/test_snow_redist.py`, `tests/test_flags.py`) to the port alone.
The two-step models against `seaice_tpu` are in
`tests/test_torch_column_model.py`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu import column as J
from seaice_tpu_torch import config as C
from seaice_tpu_torch import column as T
from seaice_tpu_torch.column import atmo, dedd, snow, zerolayer
from seaice_tpu_torch.column import constants as c
from seaice_tpu_torch.column.bl99 import temperature_changes
from seaice_tpu_torch.column.driver import (AtmosForcing, ColumnPhysics,
                                            OceanForcing, slab_ocean_frzmlt)
from seaice_tpu_torch.column.thermo_shared import (
    ice_enthalpy_from_temperature, melting_temperature, salinity_profile,
    snow_enthalpy_from_temperature)
from seaice_tpu_torch.model import SeaIceModel
from seaice_tpu_torch.testcases import box
from tests.test_torch_column_functions import (NB, NCAT, NI, _both,
                                               _compare, _solver_inputs,
                                               _state, _sw_inputs,
                                               _vertical_inputs)

torch.set_num_threads(1)

F64 = torch.float64
LIMIT = 1e-12


# -- part 1: functions against seaice_tpu -----------------------------------

def _zerolayer_inputs(rng):
    shp = (NB, NCAT)
    return dict(
        rhoa=rng.uniform(1.2, 1.4, shp), flw=rng.uniform(150.0, 330.0, shp),
        potT=rng.uniform(240.0, 276.0, shp), Qa=rng.uniform(2e-4, 4e-3, shp),
        shcoef=rng.uniform(5.0, 15.0, shp),
        lhcoef=rng.uniform(10.0, 30.0, shp),
        fswsfc=rng.uniform(0.0, 150.0, shp),
        hilyr=rng.uniform(0.05, 3.0, shp),
        hslyr=rng.uniform(0.0, 0.4, shp) * (rng.random(shp) < 0.6),
        Tsf=rng.uniform(-30.0, 0.0, shp), Tbot=np.full(shp, -1.8))


def test_zerolayer_temperature_matches_reference():
    """The zero-layer Newton solve: every output, the converged mask
    and the iteration count's stopping point equal to LIMIT."""
    rng = np.random.default_rng(1)
    a, t = _both(_zerolayer_inputs(rng))
    ref = J.zerolayer.zerolayer_temperature(1800.0, **a)
    got = zerolayer.zerolayer_temperature(1800.0, **t)
    _compare(ref, got, LIMIT)
    assert bool(got.converged.all()) and got.iterations > 2


# a column of the subdiv-3 full-physics sphere (an ice-free category, its
# placeholder thickness 0.1 m): in float32 the Newton step cycles between
# two neighbours of the root (ROADMAP Queue 3, fault 14)
CYCLING_COLUMN = dict(
    rhoa=1.2999999523162842, flw=180.0, potT=254.3353729248047,
    Qa=0.00039999998989515007, shcoef=18.755878448486328,
    lhcoef=49937.23828125, fswsfc=0.0, hilyr=0.10000000149011612,
    hslyr=0.0, Tsf=0.0, Tbot=-1.7999999523162842)


def test_zerolayer_float32_converges_where_the_newton_step_cycles():
    """The reference's float32 solve leaves this column unconverged
    after NITERMAX iterations; the port's float32 solve converges in a
    few, within 1e-5 K of the float64 root; float64 equals the
    reference."""
    ref = {dt: J.zerolayer.zerolayer_temperature(1800.0, **{
        k: jnp.asarray([v], dt) for k, v in CYCLING_COLUMN.items()})
        for dt in (jnp.float32, jnp.float64)}
    assert not bool(ref[jnp.float32].converged[0])
    got = {dt: zerolayer.zerolayer_temperature(1800.0, **{
        k: torch.tensor([v], dtype=dt) for k, v in CYCLING_COLUMN.items()})
        for dt in (torch.float32, F64)}
    assert bool(got[torch.float32].converged[0])
    assert got[torch.float32].iterations <= 6
    np.testing.assert_allclose(float(got[torch.float32].Tsf[0]),
                               float(got[F64].Tsf[0]), atol=1e-5)
    _compare(ref[jnp.float64], got[F64], LIMIT)


def _snow_inputs(rng, ns=2):
    s = _state(rng)
    shp = s["aicen"].shape + (ns,)
    return dict(
        aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
        zqsn=np.asarray(J.thermo_shared.snow_enthalpy_from_temperature(
            jnp.asarray(rng.uniform(-25.0, -0.5, shp)))),
        tsfc=s["tsfc"], zTin1=s["Tin"][..., 0],
        rsnw=rng.uniform(40.0, 2000.0, shp),
        smice=rng.uniform(100.0, 400.0, shp),
        smliq=rng.uniform(0.0, 80.0, shp) * (rng.random(shp) < 0.5),
        wind=rng.uniform(0.0, 25.0, NB),
        fsnow=rng.uniform(0.0, 2e-4, NB) * (rng.random(NB) < 0.6),
        rhos=rng.uniform(80.0, 460.0, shp),
        alvl=rng.uniform(0.2, 1.0, s["aicen"].shape),
        vlvl=rng.uniform(0.2, 1.0, s["aicen"].shape))


SNOW_FUNCTIONS = {
    "wet_metamorph": lambda m, x: m.snow_wet_metamorph(
        3600.0, x["rsnw"], x["smice"], x["smliq"]),
    "dry_metamorph": lambda m, x: m.snow_dry_metamorph(
        3600.0, x["rsnw"], x["zqsn"], x["tsfc"], x["zTin1"],
        x["vsnon"], x["vicen"]),
    "update_snow_radius": lambda m, x: m.update_snow_radius(
        86400.0, x["rsnw"], x["aicen"], x["vicen"], x["vsnon"], x["zqsn"],
        x["tsfc"], x["zTin1"], x["smice"], x["smliq"]),
    "drain_snow": lambda m, x: m.drain_snow(
        3600.0, x["vsnon"], x["aicen"], x["smice"], x["smliq"] * 3.0),
    "wind_snow_loss": lambda m, x: m.wind_snow_loss(x["wind"], x["fsnow"]),
    "wind_compaction": lambda m, x: m.wind_compaction(
        3600.0, x["wind"][:, None, None] + 0.0 * x["rhos"], x["rhos"]),
    "effective_density": lambda m, x: m.snow_effective_density(
        x["smice"], x["smliq"]),
}


@pytest.mark.parametrize("name", sorted(SNOW_FUNCTIONS))
def test_snow_function_matches_reference(name):
    rng = np.random.default_rng(2)
    a, t = _both(_snow_inputs(rng))
    _compare(SNOW_FUNCTIONS[name](J.snow, a), SNOW_FUNCTIONS[name](snow, t),
             LIMIT)


@pytest.mark.parametrize("scheme", ["bulk", "ITDsd", "ITDrdg"])
@pytest.mark.parametrize("ns", [1, 3])
def test_snow_redistribution_matches_reference(scheme, ns):
    """All three schemes (the bulk scheme takes the uniform weights, as
    in the reference), one snow layer and three (the conservative
    regrid)."""
    rng = np.random.default_rng(3 + ns)
    a, t = _both(_snow_inputs(rng, ns))

    def run(m, x):
        return m.snow_redistribution(
            1800.0, x["wind"], x["fsnow"], x["aicen"], x["vicen"],
            x["vsnon"], x["zqsn"], x["rhos"], scheme=scheme,
            alvl=x["alvl"], vlvl=x["vlvl"])
    ref, got = run(J.snow, a), run(snow, t)
    _compare(ref, got, LIMIT)
    assert float(got.fsloss.max()) > 0.0


@pytest.mark.parametrize("use_ponds", [True, False],
                         ids=["ponds", "no_ponds"])
def test_neutral_drag_coeffs_matches_reference(use_ponds):
    """Every coefficient and geometry field of the Tsamados form drag,
    on a state with open water, slivers, level and ridged ice."""
    rng = np.random.default_rng(4)
    s = _state(rng)
    shp = s["aicen"].shape
    a, t = _both(dict(
        apnd=rng.uniform(0.0, 0.4, shp) * (rng.random(shp) < 0.6),
        hpnd=rng.uniform(0.0, 0.3, shp),
        alvl=np.where(rng.random(shp) < 0.2, 1.0,
                      rng.uniform(0.2, 1.0, shp)),
        aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
        vlvl=rng.uniform(0.2, 1.0, shp)))

    def run(m, x):
        return m.neutral_drag_coeffs(
            x["apnd"], x["hpnd"], x["alvl"], x["aicen"], x["vicen"],
            x["vsnon"], vlvl=x["vlvl"], use_ponds=use_ponds)
    _compare(run(J.atmo, a), run(atmo, t), LIMIT)


@pytest.mark.parametrize("option", ["highfreq", "Cdn_atm"])
def test_atmo_boundary_layer_option_matches_reference(option):
    rng = np.random.default_rng(5)
    shp = (NB, NCAT)
    x = dict(Tsf=rng.uniform(-30.0, 0.0, shp),
             potT=rng.uniform(240.0, 276.0, shp),
             uatm=rng.normal(0.0, 6.0, shp), vatm=rng.normal(0.0, 6.0, shp),
             zlvl=np.full(shp, 10.0), Qa=rng.uniform(2e-4, 4e-3, shp),
             rhoa=rng.uniform(1.2, 1.4, shp))
    x["wind"] = np.sqrt(x["uatm"] ** 2 + x["vatm"] ** 2)
    if option == "highfreq":
        kw = dict(uvel=rng.normal(0.0, 0.3, shp),
                  vvel=rng.normal(0.0, 0.3, shp))
    else:
        kw = dict(Cdn_atm=np.where(rng.random(shp) < 0.1, 0.0,
                                   rng.uniform(5e-4, 4e-3, shp)))
    a, t = _both(dict(x, **kw))

    def run(m, y):
        return m.atmo_boundary_layer(
            *(y[k] for k in ("Tsf", "potT", "uatm", "vatm", "wind", "zlvl",
                             "Qa", "rhoa")), natmiter=5,
            highfreq=option == "highfreq",
            **{k: y[k] for k in kw})
    _compare(run(J.atmo, a), run(atmo, t), LIMIT)


VERTICAL_CASES = {
    "ktherm0": dict(ktherm=0),
    "ktherm0_prescribed": dict(ktherm=0, prescribed=True),
    "bl99_prescribed": dict(ktherm=1, prescribed=True),
    "bl99_snow_tracers": dict(ktherm=1, snow=True),
    "mushy_snow_tracers": dict(ktherm=2, snow=True),
    "ktherm0_snow_tracers": dict(ktherm=0, snow=True),
}


@pytest.mark.parametrize("name", sorted(VERTICAL_CASES))
def test_thermo_vertical_option_matches_reference(name):
    """The vertical driver with ktherm=0, with the prescribed surface
    fluxes of calc_Tsfc=False (ktherm 0 and 1), and with the snow mass
    and grain-radius tracers (ktherm 0, 1, 2): every output to LIMIT,
    the converged masks equal."""
    opt = VERTICAL_CASES[name]
    ktherm = opt["ktherm"]
    rng = np.random.default_rng(6 + sorted(VERTICAL_CASES).index(name))
    x = _vertical_inputs(rng, ktherm)
    shp = x["aicen"].shape
    if opt.get("prescribed"):
        x.update(fsurf=rng.uniform(-40.0, 60.0, shp),
                 fcondtop=rng.uniform(-40.0, 20.0, shp),
                 flat=rng.uniform(-10.0, 2.0, shp),
                 fsens=rng.uniform(-20.0, 20.0, shp))
    if opt.get("snow"):
        x.update(smice=rng.uniform(100.0, 400.0, shp + (1,)),
                 smliq=rng.uniform(0.0, 60.0, shp + (1,)),
                 rsnw=rng.uniform(54.5, 1500.0, shp + (1,)))
    a, t = _both(x)
    pos = ("aicen vicen vsnon Tsf zqin zqsn zSin flw potT Qa rhoa fsnow "
           "fbot Tbot fswsfc fswint Sswabs Iswabs shcoef lhcoef").split()

    def run(m, y):
        kw = dict(ktherm=ktherm, frain=y["frain"])
        if ktherm == 2:
            kw.update(sss=y["sss"], apond=y["apond"], hpond=y["hpond"])
        if opt.get("prescribed"):
            kw["prescribed_sfc_fluxes"] = {
                k: y[k] for k in ("fsurf", "fcondtop", "flat", "fsens")}
        if opt.get("snow"):
            kw.update(smice=y["smice"], smliq=y["smliq"], rsnw=y["rsnw"])
        return m.vertical.thermo_vertical(3600.0, *(y[k] for k in pos),
                                          **kw)
    ref, got = run(J, a), run(T, t)
    _compare(ref, got, LIMIT)
    if opt.get("snow"):
        assert not torch.equal(got.smice, t["smice"])
        assert not torch.equal(got.rsnw, t["rsnw"])


def test_shortwave_dedd_grain_radius_matches_reference():
    """dEdd with the grain-radius tracer (clipped to [54.526, 1500]) in
    place of the parametric radius, one and two snow layers."""
    rng = np.random.default_rng(9)
    _, x = _sw_inputs(rng)
    shp = x["aicen"].shape
    x = dict(x, r1=rng.uniform(20.0, 2500.0, shp + (1,)),
             r2=rng.uniform(20.0, 2500.0, shp + (2,)))
    a, t = _both(x)

    def run(m, y):
        return {f"ns{ns}": m.dedd.shortwave_dedd(
            y["aicen"], y["vicen"], y["vsnon"], y["tsfc"], y["coszen"],
            *y["sw"], NI, ns, rsnw=y[f"r{ns}"]) for ns in (1, 2)}
    ref, got = run(J, a), run(T, t)
    _compare(ref, got, LIMIT)
    plain = dedd.shortwave_dedd(t["aicen"], t["vicen"], t["vsnon"],
                                t["tsfc"], t["coszen"], *t["sw"], NI, 1)
    assert not torch.allclose(plain.alvdr, got["ns1"].alvdr)


def test_ridging_and_itd_remap_carry_snow_tracers():
    """Ridging, the ITD remap and the small-ice cleanup carry the three
    snow tracers as snow-volume tracers, as the JAX package's do: equal
    to LIMIT, and the snow-volume-weighted ice mass is conserved by the
    remap."""
    rng = np.random.default_rng(10)
    s = _state(rng)
    shp = s["aicen"].shape + (1,)
    vicen2 = s["vicen"] * rng.uniform(0.9, 1.1, s["vicen"].shape)
    a, t = _both(dict(
        aicen=s["aicen"], vicen=s["vicen"], vicen2=vicen2,
        vsnon=s["vsnon"], tsfc=s["tsfc"], qin=s["qin"], sin=s["sin"],
        qsn=s["qsn"], smice=rng.uniform(100.0, 400.0, shp),
        smliq=rng.uniform(0.0, 60.0, shp),
        rsnw=rng.uniform(54.5, 1500.0, shp),
        conv=rng.uniform(0.0, 4e-6, NB), shear=rng.uniform(0.0, 4e-6, NB)))
    h = s["hmax"]

    def run(m, x):
        st = {k: x[k] for k in ("smice", "smliq", "rsnw")}
        st["snowEnthalpy"] = x["qsn"]
        at = {"surfaceTemperature": x["tsfc"]}
        it_ = {"iceEnthalpy": x["qin"], "iceSalinity": x["sin"]}
        return dict(
            ridge=m.ridging.ridge_ice(
                1800.0, h, x["conv"], x["shear"], x["aicen"] * 1.08,
                x["vicen"] * 1.08, x["vsnon"], at, it_, st),
            remap=m.itd.linear_itd_remap(
                h, x["aicen"], x["vicen"], x["aicen"], x["vicen2"],
                x["vsnon"], at, it_, st),
            clean=m.itd.cleanup_small_ice(x["aicen"], x["vicen"],
                                          x["vsnon"], at, it_, st))
    ref, got = run(J, a), run(T, t)
    _compare(ref, got, LIMIT)
    vsn, st = got["remap"][2], got["remap"][5]
    np.testing.assert_allclose(
        float((vsn * st["smice"][..., 0]).sum()),
        float((t["vsnon"] * t["smice"][..., 0]).sum()), rtol=1e-12)


# -- part 2: the JAX package's own tests of these options, ported ----------

def test_zerolayer_temperature():
    """0-layer surface balance (ktherm=0, reference ice_therm_0layer):
    cold forcing cools the surface; equilibrium satisfies
    fsurf = kh (Tsf - Tbot)."""
    nb = 3

    def f(*v):
        return torch.tensor(v, dtype=F64)

    res = zerolayer.zerolayer_temperature(
        3600.0, rhoa=torch.full((nb,), 1.3, dtype=F64),
        flw=f(160.0, 300.0, 340.0), potT=f(250.0, 270.0, 278.0),
        Qa=f(3e-4, 2e-3, 4e-3), shcoef=torch.full((nb,), 10.0, dtype=F64),
        lhcoef=torch.full((nb,), 20.0, dtype=F64),
        fswsfc=f(0.0, 30.0, 150.0), hilyr=torch.full((nb,), 1.5, dtype=F64),
        hslyr=f(0.1, 0.1, 0.0), Tsf=torch.full((nb,), -5.0, dtype=F64),
        Tbot=torch.full((nb,), -1.8, dtype=F64))
    assert bool(res.converged.all())
    tsf = res.Tsf.numpy()
    assert tsf[0] < -15.0          # polar night cools strongly
    assert tsf[2] == 0.0 or tsf[2] > -1.0   # warm sunny -> near melting
    kratio = zerolayer.KSEAICE_0LAYER / c.KSNO
    heff = 1.5 + kratio * np.array([0.1, 0.1, 0.0])
    kh = zerolayer.KSEAICE_0LAYER / heff
    res_bal = res.fsurfn.numpy() - kh * (tsf - (-1.8))
    assert abs(res_bal[0]) < 0.5    # W/m^2


def test_snow_physics():
    """Snow metamorphism/drainage/wind (reference ice_snow.F90)."""
    nb, ncat, ns = 4, 2, 1

    def full(shape, v):
        return torch.full(shape, v, dtype=F64)

    rsnw = full((nb, ncat, ns), snow.RSNW_FALL)
    aicen = full((nb, ncat), 0.5)
    vicen = aicen * 1.5
    vsnon = aicen * 0.2
    zqsn = snow_enthalpy_from_temperature(full((nb, ncat, ns), -10.0))
    smice = full((nb, ncat, ns), 330.0)
    smliq = torch.zeros((nb, ncat, ns), dtype=F64)
    r1, _, _ = snow.update_snow_radius(
        86400.0, rsnw, aicen, vicen, vsnon, zqsn, full((nb, ncat), -15.0),
        full((nb, ncat), -5.0), smice, smliq)
    # dry metamorphism grows grains, bounded
    assert float(r1.min()) > snow.RSNW_FALL
    assert float(r1.max()) <= snow.RSNW_TMAX
    # wet snow grows faster than dry
    r_wet, _, _ = snow.update_snow_radius(
        86400.0, rsnw, aicen, vicen, vsnon, zqsn, full((nb, ncat), -1.0),
        full((nb, ncat), -1.0), smice, full((nb, ncat, ns), 30.0))
    assert float(r_wet.mean()) > float(r1.mean())
    # drainage: saturated snow sheds liquid to the base
    sl2, meltsliq = snow.drain_snow(3600.0, vsnon, aicen, smice,
                                    full((nb, ncat, ns), 120.0))
    assert float(meltsliq.min()) > 0.0
    assert float(sl2.max()) < 120.0
    # wind loss caps at 30%
    _, lost = snow.wind_snow_loss(torch.tensor([0.0, 25.0], dtype=F64),
                                  full((2,), 1e-5))
    assert float(lost[0]) == 0.0
    np.testing.assert_allclose(float(lost[1]), 0.3e-5, rtol=1e-6)


def test_form_drag_tsamados():
    """Neutral form drag (reference neutral_drag_coeffs,
    ice_atmo.F90:496-827): ridged ice raises drag above the skin value,
    open water falls back to log-law/dragio defaults, and all components
    stay within the reference caps."""
    nb, ncat = 3, 5
    hcat = torch.tensor([0.3, 0.9, 1.6, 2.8, 4.5], dtype=F64)
    aicen = torch.stack([torch.full((ncat,), 0.19, dtype=F64),
                         torch.full((ncat,), 0.19, dtype=F64),
                         torch.zeros(ncat, dtype=F64)])
    vicen = aicen * hcat
    vsnon = aicen * 0.05
    alvl = torch.stack([torch.full((ncat,), 0.3, dtype=F64),
                        torch.ones(ncat, dtype=F64),
                        torch.zeros(ncat, dtype=F64)])
    apnd = torch.full((nb, ncat), 0.2, dtype=F64)
    hpnd = torch.full((nb, ncat), 0.1, dtype=F64)
    r = atmo.neutral_drag_coeffs(apnd, hpnd, alvl, aicen, vicen, vsnon)
    cd_a, cd_o = r.Cdn_atm.numpy(), r.Cdn_ocn.numpy()
    assert float(r.hridge[0]) > 0.0 and float(r.hridge[1]) == 0.0
    assert cd_a[0] > cd_a[1] and cd_o[0] > cd_o[1]
    np.testing.assert_allclose(
        cd_a[2], (c.VONKAR / np.log(c.ZREF / c.ICERUF)) ** 2, rtol=1e-12)
    np.testing.assert_allclose(cd_o[2], c.DRAGIO, rtol=1e-12)
    assert (cd_a <= 0.02 + 1e-15).all() and (cd_o <= 0.06 + 1e-15).all()
    for f in r:
        assert (f.numpy() >= -1e-15).all()
    assert float(r.hkeel[0]) > float(r.hridge[0])
    assert float(r.hdraft[0]) < float((vicen[0].sum() + 1e-9) /
                                      aicen[0].sum()) + 0.1


def test_atmo_highfreq_and_formdrag_coupling():
    """highfreq (Roberts 2014 ice-relative wind) and the form-drag
    neutral coefficient in the bulk boundary layer (reference
    ice_atmo.F90:175-216, :305-318)."""
    one = torch.ones(4, dtype=F64)
    args = dict(Tsf=-5.0 * one, potT=260.0 * one, uatm=8.0 * one,
                vatm=0.0 * one, wind=8.0 * one, zlvl=10.0 * one,
                Qa=0.0005 * one, rhoa=1.3 * one)
    base = atmo.atmo_boundary_layer(**args)
    # ice moving with the wind reduces the highfreq stress
    hf = atmo.atmo_boundary_layer(**args, highfreq=True, uvel=4.0 * one,
                                  vvel=0.0 * one)
    assert float(hf.strx.mean()) < float(base.strx.mean())
    assert float(hf.strx.min()) > 0.0
    # stationary ice: highfreq stress close to the standard bulk value
    hf0 = atmo.atmo_boundary_layer(**args, highfreq=True, uvel=0.0 * one,
                                   vvel=0.0 * one)
    np.testing.assert_allclose(hf0.strx.numpy(), base.strx.numpy(),
                               rtol=0.3)
    # a larger form-drag coefficient raises the exchange coefficients
    fd = atmo.atmo_boundary_layer(**args, Cdn_atm=0.004 * one)
    assert float(fd.shcoef.mean()) > float(base.shcoef.mean())
    assert float(fd.strx.mean()) > float(base.strx.mean())
    with pytest.raises(ValueError, match="uvel"):
        atmo.atmo_boundary_layer(**args, highfreq=True)


# tests/test_calc_tsfc.py

def _cold_columns(n=8, ni=7, ns=1, seed=0):
    rng = np.random.default_rng(seed)
    dt = 3600.0
    hilyr = rng.uniform(0.1, 0.4, n)
    hslyr = np.where(rng.uniform(size=n) < 0.5, rng.uniform(0.05, 0.3, n),
                     0.0)
    zTin = rng.uniform(-20.0, -2.0, (n, ni))
    zSin = np.tile(np.linspace(1.0, 3.2, ni), (n, 1))
    zTsn = rng.uniform(-25.0, -5.0, (n, ns))
    Tsf = rng.uniform(-30.0, -5.0, n)
    t = {k: torch.as_tensor(v) for k, v in dict(
        hilyr=hilyr, hslyr=hslyr, zTin=zTin, zSin=zSin, zTsn=zTsn,
        Tsf=Tsf).items()}
    t["zqin"] = ice_enthalpy_from_temperature(t["zTin"],
                                              -t["zSin"] * c.DEPRESST)
    t["zqsn"] = snow_enthalpy_from_temperature(t["zTsn"])
    t["Tbot"] = torch.full((n,), -1.8, dtype=F64)
    t["einit"] = (t["hilyr"][:, None] * t["zqin"]).sum(-1) + torch.where(
        t["hslyr"] > c.HS_MIN / ns, (t["hslyr"][:, None] *
                                     t["zqsn"]).sum(-1), 0.0)
    l_snow = hslyr > c.HS_MIN / ns

    def full(v):
        return torch.full((n,), v, dtype=F64)
    t.update(dt=dt, rhoa=full(1.3), flw=full(180.0), potT=full(253.0),
             Qa=full(5e-4), shcoef=full(10.0), lhcoef=full(15.0),
             fswsfc=full(5.0), fswint=torch.as_tensor(0.5 + 0.5 * l_snow),
             Sswabs=torch.as_tensor(np.where(l_snow[:, None], 0.5 / ns,
                                             0.0) * np.ones((n, ns))),
             Iswabs=torch.full((n, ni), 0.5 / ni, dtype=F64))
    return t


def _solve(p, **kw):
    return temperature_changes(
        p["dt"], p["rhoa"], p["flw"], p["potT"], p["Qa"], p["shcoef"],
        p["lhcoef"], p["fswsfc"], p["fswint"], p["Sswabs"], p["Iswabs"],
        p["hilyr"], p["hslyr"], p["zqin"], p["zTin"], p["zqsn"],
        p["zTsn"], p["zSin"], p["Tsf"], p["Tbot"], p["einit"], **kw)


def _prescribed(n, fsurf, fcondtop, flat, fsens):
    return {k: torch.full((n,), v, dtype=F64) for k, v in (
        ("fsurfn_f", fsurf), ("fcondtopn_f", fcondtop), ("flatn_f", flat),
        ("fsensn_f", fsens))}


def test_know_tsfc_reproduces_calc_tsfc_solution():
    """Feeding the converged calc_Tsfc=True surface fluxes back in as
    prescribed fluxes reproduces the same interior temperatures: the
    know_Tsfc system is the calc system with the Tsf row eliminated at
    its solution."""
    p = _cold_columns()
    ref = _solve(p)
    ok = ref.converged.numpy()
    assert ok.sum() >= 3
    got = _solve(dict(p, Tsf=ref.Tsf), calc_tsfc=False,
                 fsurfn_f=ref.fsurfn, fcondtopn_f=ref.fcondtopn,
                 flatn_f=ref.flatn, fsensn_f=ref.fsensn)
    assert bool(got.converged.numpy()[ok].all())
    np.testing.assert_allclose(got.zTin.numpy()[ok], ref.zTin.numpy()[ok],
                               atol=0.15)
    np.testing.assert_array_equal(got.Tsf.numpy(), ref.Tsf.numpy())
    np.testing.assert_array_equal(got.fcondtopn.numpy()[ok],
                                  ref.fcondtopn.numpy()[ok])
    np.testing.assert_array_equal(got.fsurfn.numpy()[ok],
                                  ref.fsurfn.numpy()[ok])


def test_bl99_ice_free_columns_keep_the_loop_running():
    """ROADMAP Queue 3 fault 15, in both packages: a column without ice
    (no ice or snow layers, Tsfc 0, as the vertical solve hands it to
    BL99) mostly never passes the convergence test, so the loop runs
    NITERMAX iterations although every iced column converged; the two
    packages flag the same columns."""
    rng = np.random.default_rng(0)
    x = _solver_inputs(rng, mushy=False)
    free = np.arange(x["hilyr"].shape[0]) < x["hilyr"].shape[0] // 3
    for k in ("hilyr", "hslyr", "Tsf"):
        x[k] = np.where(free, 0.0, x[k])
    x["zqsn"] = np.full_like(x["zqsn"], -c.RHOS * c.LFRESH)
    x["zTsn"] = np.zeros_like(x["zTsn"])
    x["einit"] = (x["hilyr"][:, None] * x["zqin"]).sum(-1) + \
        (x["hslyr"][:, None] * x["zqsn"]).sum(-1)
    a, t = _both(x)
    names = ("rhoa flw potT Qa shcoef lhcoef fswsfc fswint Sswabs Iswabs "
             "hilyr hslyr zqin zTin zqsn zTsn zSin Tsf Tbot einit").split()
    ref = J.bl99.temperature_changes(3600.0, *(a[k] for k in names))
    got = temperature_changes(3600.0, *(t[k] for k in names))
    conv = got.converged.numpy()
    assert np.array_equal(conv, np.asarray(ref.converged))
    assert conv[~free].all() and not conv[free].all()
    assert got.iterations == 100


def test_know_tsfc_energy_closure():
    """Condition 5 (energy conservation) still gates convergence with
    prescribed fluxes: (enew-einit)/dt = fcondtop - fcondbot + fswint to
    FERRMAX."""
    p = _cold_columns(seed=3)
    n = p["Tsf"].shape[0]
    got = _solve(p, calc_tsfc=False,
                 **_prescribed(n, -20.0, -15.0, -5.0, -8.0))
    assert bool(got.converged.all())
    ns = p["zTsn"].shape[-1]
    hs = p["hslyr"].numpy()
    l_snow = hs > c.HS_MIN / ns
    enew = (p["hilyr"].numpy()[:, None] * got.zqin.numpy()).sum(-1) + \
        np.where(l_snow, (hs[:, None] * got.zqsn.numpy()).sum(-1), 0.0)
    lhs = (enew - p["einit"].numpy()) / p["dt"]
    rhs = (got.fcondtopn - got.fcondbot + got.fswint).numpy()
    np.testing.assert_allclose(lhs, rhs, atol=c.FERRMAX)


def test_prescribed_fluxes_change_the_answer():
    p = _cold_columns(seed=5)
    n = p["Tsf"].shape[0]
    a = _solve(p, calc_tsfc=False, **_prescribed(n, -20.0, -15.0, 0.0, 0.0))
    b = _solve(p, calc_tsfc=False, **_prescribed(n, 5.0, 10.0, 0.0, 0.0))
    assert float((a.zTin - b.zTin).abs().max()) > 0.1


def test_mushy_plus_know_tsfc_is_a_config_error():
    with pytest.raises(ValueError, match="calc_surface_temperature"):
        ColumnPhysics(5, 7, ktherm=2, calc_tsfc=False, device="cpu")


def _box_column_inputs(nc, ncat):
    z = torch.zeros(nc, dtype=F64)

    def full(v):
        return torch.full((nc,), v, dtype=F64)
    atm = AtmosForcing(
        air_temperature=full(253.0), specific_humidity=full(5e-4),
        u_air=full(5.0), v_air=z, longwave_down=full(180.0),
        sw_vis_dir=z, sw_vis_dif=z, sw_ir_dir=z, sw_ir_dif=z,
        rain_rate=z, snow_rate=z, air_density=full(1.3),
        air_level_height=full(10.0))
    ocn = OceanForcing(sst=full(-1.8), sss=full(34.0),
                       freezing_temperature=full(-1.8), frzmlt=z,
                       mixed_layer_depth=full(20.0))
    sfcf = {k: torch.full((nc, ncat), v, dtype=F64) for k, v in (
        ("fsurf", -25.0), ("fcondtop", -20.0), ("flat", -4.0),
        ("fsens", -10.0))}
    return atm, ocn, sfcf


def test_model_step_with_prescribed_fluxes():
    """A full model step in calc_Tsfc=False mode runs and differs from
    the calc_Tsfc=True trajectory; Tsfc stays at the coupler's value
    wherever ice persists; without the fluxes the step raises."""
    mesh = box.box_test_mesh(8, 8)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    ncat = 3
    base = C.Config(
        run=C.RunConfig(dt=3600.0, n_categories=ncat),
        velocity=C.VelocitySolverConfig(elastic_subcycle_number=4),
        column=C.ColumnConfig(ktherm=1))
    off = dataclasses.replace(base, column=dataclasses.replace(
        base.column, calc_surface_temperature=False))
    area, vol, snow_v = box.box_initial_state(mesh, n_categories=ncat)
    forcing = box.box_forcing(mesh, 0.0, F64, "cpu")
    atm, ocn, sfcf = _box_column_inputs(mesh.n_cells, ncat)

    m_on = SeaIceModel(mesh, base, dtype=F64, device="cpu")
    out_on, _ = m_on.make_step()(m_on.tensors,
                                 m_on.init_state(area, vol, snow_v),
                                 forcing, atm, ocn)
    m_off = SeaIceModel(mesh, off, dtype=F64, device="cpu")
    s_off = m_off.init_state(area, vol, snow_v)
    step = m_off.make_step()
    with pytest.raises(ValueError, match="sfc_fluxes"):
        step(m_off.tensors, s_off, forcing, atm, ocn)
    out_off, _ = step(m_off.tensors, s_off, forcing, atm, ocn,
                      sfc_fluxes=sfcf)
    t_on = out_on.tracers["surfaceTemperature"].numpy()
    t_off = out_off.tracers["surfaceTemperature"].numpy()
    a_off = out_off.tracers["iceAreaCategory"].numpy()
    a0 = s_off.tracers["iceAreaCategory"].numpy()
    t0 = s_off.tracers["surfaceTemperature"].numpy()
    keep = (a0 > 0.01) & (a_off > 0.01)
    np.testing.assert_allclose(t_off[keep], t0[keep], atol=1e-9)
    assert np.abs(t_on - t_off).max() > 0.01


def test_namelist_maps_calc_surface_temperature():
    from seaice_tpu_torch.namelist import config_from_namelist
    cfg, _ = config_from_namelist({
        "atmosphere": {"config_calc_surface_temperature": False}})
    assert cfg.column.calc_surface_temperature is False


# tests/test_snow_redist.py

def _redist_state(nb=3, ncat=4, ns=3, open_water=0.1, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((nb, ncat)) + 0.2
    a = a / a.sum(-1, keepdims=True) * (1.0 - open_water)
    hin = np.linspace(0.4, 3.0, ncat)[None, :] * np.ones((nb, 1))
    hsn = 0.1 + 0.2 * rng.random((nb, ncat))
    zq = snow_enthalpy_from_temperature(
        torch.as_tensor(-8.0 - 6.0 * rng.random((nb, ncat, ns))))
    return (torch.as_tensor(a), torch.as_tensor(a * hin),
            torch.as_tensor(a * hsn), zq,
            torch.full((nb, ncat, ns), 200.0, dtype=F64))


def _wind(v, n=3):
    return torch.full((n,), v, dtype=F64)


def test_mass_and_energy_conservation():
    a, vin, vsn, zq, rhos_cmp = _redist_state()
    dt = 3600.0
    out = snow.snow_redistribution(dt, _wind(15.0), _wind(0.0), a, vin,
                                   vsn, zq, rhos_cmp, scheme="ITDsd")
    ns = zq.shape[-1]
    m0 = (c.RHOS * vsn.sum(-1)).numpy()
    m1 = (c.RHOS * out.vsnon.sum(-1)).numpy()
    # `fresh` carries the ocean mass flux (lead-lost snow included);
    # fsloss is the diagnostic duplicate of the lead loss
    np.testing.assert_allclose(m0, m1 + out.fresh.numpy() * dt,
                               rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(out.fsloss.numpy() * dt,
                               out.fresh.numpy() * dt, atol=1e-8)
    e0 = (vsn[..., None] * zq / ns).sum((-2, -1)).numpy()
    e1 = (out.vsnon[..., None] * out.zqsn / ns).sum((-2, -1)).numpy()
    np.testing.assert_allclose(e0 - e1, out.fhocn.numpy() * dt, rtol=1e-9,
                               atol=1e-5)


def test_wind_moves_snow_and_leads_lose():
    """Strong wind suspends snow; with open water some blows into leads
    (fsloss > 0); calm wind is a no-op."""
    a, vin, vsn, zq, rhos_cmp = _redist_state(open_water=0.3)
    out = snow.snow_redistribution(3600.0, _wind(20.0), _wind(0.0), a, vin,
                                   vsn, zq, rhos_cmp)
    assert float(out.fsloss.min()) > 0.0
    calm = snow.snow_redistribution(3600.0, _wind(0.0), _wind(0.0), a, vin,
                                    vsn, zq, rhos_cmp)
    np.testing.assert_allclose(calm.vsnon.numpy(), vsn.numpy(), atol=1e-14)
    assert float(calm.fsloss.abs().max()) == 0.0


def test_itdrdg_prefers_ridged_ice():
    """ITDrdg redeposits suspended snow preferentially onto ridged
    categories (the (1+sfac) weighting)."""
    a, vin, vsn, zq, rhos_cmp = _redist_state(seed=2)
    alvl = torch.tensor([[1.0, 1.0, 1.0, 0.0]] * 3, dtype=F64)
    out = snow.snow_redistribution(3600.0, _wind(18.0), _wind(0.0), a, vin,
                                   vsn, zq, rhos_cmp, scheme="ITDrdg",
                                   alvl=alvl, vlvl=alvl)
    base = snow.snow_redistribution(3600.0, _wind(18.0), _wind(0.0), a,
                                    vin, vsn, zq, rhos_cmp, scheme="ITDsd")
    gain_rdg = (out.vsnon - vsn)[:, 3].numpy()
    gain_sd = (base.vsnon - vsn)[:, 3].numpy()
    assert (gain_rdg > gain_sd - 1e-14).all()


def test_fresh_snow_wind_compaction():
    """Snowfall under strong wind compacts the top snow layer."""
    a, vin, vsn, zq, rhos_cmp = _redist_state()
    out = snow.snow_redistribution(3600.0, _wind(20.0), _wind(1e-4), a, vin,
                                   vsn, zq, rhos_cmp)
    top = out.rhos_cmpn[..., 0].numpy()
    assert (top >= rhos_cmp[..., 0].numpy() - 1e-12).all()
    assert top.max() > 200.0 + 1.0


def _box_full_physics(cfg, nx=5):
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    mesh = box.box_test_mesh(nx, nx)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=F64, device="cpu")
    area, vol, snow_v, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, F64, "cpu")
    return mesh, model, area, vol, snow_v, extra, atm, ocn, coszen


def test_model_step_with_snwredist():
    """snwredist='ITDrdg' through the full model step stays finite, and
    the snow stays non-negative."""
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=3, n_ice_layers=4),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=2, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(ktherm=1, use_snow_tracers=True,
                              snwredist="ITDrdg", pond_scheme="lvl"))
    mesh, model, area, vol, snow_v, extra, atm, ocn, coszen = \
        _box_full_physics(cfg)
    state = model.init_state(area, vol, snow_v)
    state = state.replace(tracers=dict(state.tracers, **extra))
    forcing = box.box_forcing(mesh, 0.0, F64, "cpu")
    step = model.make_step()
    for _ in range(2):
        state, diags = step(model.tensors, state, forcing, atm, ocn,
                            coszen=coszen)
    for k, v in state.tracers.items():
        assert bool(torch.isfinite(v).all()), k
    assert float(state.tracers["snowVolumeCategory"].min()) >= 0.0
    assert "redist_fresh" in diags["coupling_prep"]


def test_with_column_equals_a_new_model():
    """`SeaIceModel.with_column` gives the model the constructor builds
    for the same options: its config, its tracer tree, and a step from
    the same state bitwise; the model it came from keeps its own."""
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=3, n_ice_layers=4),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=2, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(ktherm=2, pond_scheme="lvl"))
    opts = dict(use_snow_tracers=True, snwredist="ITDsd", highfreq=True)
    new_cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, **opts))
    mesh, base, area, vol, snow_v, extra, atm, ocn, coszen = \
        _box_full_physics(cfg)
    derived = base.with_column(**opts)
    built = SeaIceModel(mesh, new_cfg, dtype=F64, device="cpu")
    assert derived.cfg == built.cfg and base.cfg == cfg
    assert derived.tree.names == built.tree.names != base.tree.names
    assert derived.tensors is base.tensors
    forcing = box.box_forcing(mesh, 0.0, F64, "cpu")
    out = []
    for m in (derived, built):
        state = m.init_state(area, vol, snow_v)
        state = state.replace(tracers=dict(state.tracers, **extra))
        for _ in range(2):
            state, _ = m.make_step()(m.tensors, state, forcing, atm, ocn,
                                     coszen=coszen)
        out.append(state)
    assert set(out[0].tracers) == set(out[1].tracers)
    for k, v in out[1].tracers.items():
        assert torch.equal(out[0].tracers[k], v), k
    assert torch.equal(out[0].velocity.u_velocity, out[1].velocity.u_velocity)


def test_bulk_snwredist_flag():
    """snwredist='bulk' reduces accumulated snowfall at high wind and
    books the blown snow as ocean freshwater."""
    outs = {}
    for mode in ("none", "bulk"):
        cfg = C.box_test_config(elastic_subcycles=2)
        cfg = dataclasses.replace(cfg, column=dataclasses.replace(
            cfg.column, use_column_package=True, snwredist=mode))
        mesh, model, area, vol, snow_v, extra, atm, ocn, coszen = \
            _box_full_physics(cfg)
        nc = mesh.n_cells
        atm = atm.replace(u_air=torch.full((nc,), 20.0, dtype=F64),
                          snow_rate=torch.full((nc,), 1e-6, dtype=F64))
        st, diags = model.make_step()(
            model.tensors, model.init_state(area, vol, snow_v),
            box.box_forcing(mesh, 0.0, F64, "cpu"), atm, ocn,
            coszen=coszen)
        outs[mode] = (st.tracers["snowVolumeCategory"].numpy(),
                      diags["column_fluxes"].fresh.numpy())
    assert outs["bulk"][0].sum() < outs["none"][0].sum()
    assert outs["bulk"][1].sum() > outs["none"][1].sum()


# tests/test_flags.py (these four options)

FLAG_NCAT, FLAG_NI, FLAG_NS = 2, 4, 1


def _flag_run(col_cfg, warm=False, steps=2):
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=FLAG_NCAT,
                        n_ice_layers=FLAG_NI),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=2, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(), column=col_cfg)
    mesh = box.box_test_mesh(6, 6)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=F64, device="cpu")
    nc = mesh.n_cells
    conc = np.clip(mesh.x_cell / box.BOX_LX, 0.05, 1.0)
    area = np.tile((conc / FLAG_NCAT)[:, None], (1, FLAG_NCAT)) * 0.9
    h = model.column.hin_max
    vol = area * 0.5 * (h[:-1] + np.minimum(h[1:], 10.0))
    state = model.init_state(area, vol, area * 0.05)
    S = torch.as_tensor(np.tile(salinity_profile(FLAG_NI),
                                (nc, FLAG_NCAT, 1)))
    has = torch.as_tensor(area[..., None] > 0)
    t0 = -2.0 if warm else -12.0
    tr = dict(state.tracers)
    tr["surfaceTemperature"] = torch.as_tensor(np.where(area > 0, t0, 0.0))
    tr["iceEnthalpy"] = ice_enthalpy_from_temperature(
        torch.where(has, t0 / 1.5, 0.0) * torch.ones_like(S),
        melting_temperature(S)) * has
    tr["iceSalinity"] = S * has
    tr["snowEnthalpy"] = snow_enthalpy_from_temperature(
        torch.full((nc, FLAG_NCAT, FLAG_NS), t0 - 1.0, dtype=F64)) * has
    state = state.replace(tracers=tr)

    forcing = box.box_forcing(mesh, 0.0, F64, "cpu")
    one = torch.ones(nc, dtype=F64)
    if warm:
        atm = AtmosForcing(
            air_temperature=276.0 * one, specific_humidity=0.003 * one,
            u_air=forcing.u_air_velocity, v_air=forcing.v_air_velocity,
            longwave_down=300.0 * one, sw_vis_dir=250.0 * one,
            sw_vis_dif=100.0 * one, sw_ir_dir=200.0 * one,
            sw_ir_dif=80.0 * one, rain_rate=1e-5 * one,
            snow_rate=0.0 * one, air_density=1.3 * one,
            air_level_height=10.0 * one)
        sst = -0.5 * one
    else:
        atm = AtmosForcing(
            air_temperature=252.0 * one, specific_humidity=0.0004 * one,
            u_air=forcing.u_air_velocity, v_air=forcing.v_air_velocity,
            longwave_down=170.0 * one, sw_vis_dir=5.0 * one,
            sw_vis_dif=5.0 * one, sw_ir_dir=4.0 * one, sw_ir_dif=4.0 * one,
            rain_rate=0.0 * one, snow_rate=1e-5 * one,
            air_density=1.3 * one, air_level_height=10.0 * one)
        sst = -1.7 * one
    Tf = -1.8 * one
    ocn = OceanForcing(
        sst=sst, sss=34.0 * one, freezing_temperature=Tf,
        frzmlt=slab_ocean_frzmlt(sst, Tf, 20.0 * one, cfg.run.dt),
        mixed_layer_depth=20.0 * one)
    step = model.make_step()
    for _ in range(steps):
        state, diags = step(model.tensors, state, forcing, atm, ocn,
                            coszen=0.5 * one)
    return state, diags


def _signature(state):
    tr = state.tracers
    return np.concatenate([tr["iceVolumeCategory"].numpy().ravel(),
                           tr["surfaceTemperature"].numpy().ravel(),
                           state.velocity.u_velocity.numpy().ravel()])


def _assert_differs(a, b, label):
    sa, sb = _signature(a), _signature(b)
    assert np.isfinite(sa).all() and np.isfinite(sb).all(), label
    assert not np.allclose(sa, sb, rtol=1e-12, atol=1e-14), \
        f"flag {label} did not change the model answer (dead flag)"


@pytest.fixture(scope="module")
def flag_base():
    return _flag_run(C.ColumnConfig())


def test_ktherm_zero_layer_differs(flag_base):
    st, _ = _flag_run(C.ColumnConfig(ktherm=0))
    _assert_differs(st, flag_base[0], "ktherm=0")


def test_form_drag_differs(flag_base):
    st, diags = _flag_run(C.ColumnConfig(use_form_drag=True,
                                         use_level_ice=True))
    _assert_differs(st, flag_base[0], "use_form_drag")
    assert diags["column_fluxes"].Cdn_atm is not None


def test_highfreq_differs(flag_base):
    st, _ = _flag_run(C.ColumnConfig(highfreq=True))
    _assert_differs(st, flag_base[0], "highfreq")


def test_snow_tracers_with_dedd_differ():
    base = _flag_run(C.ColumnConfig(shortwave="dEdd"), warm=True)
    st, _ = _flag_run(C.ColumnConfig(shortwave="dEdd",
                                     use_snow_tracers=True), warm=True)
    _assert_differs(st, base[0], "use_snow_tracers")
    r = st.tracers["snowGrainRadius"].numpy()
    assert np.isfinite(r).all() and r.min() >= 0.0


def test_snow_liquid_ponds_need_snow_tracers():
    """The reference's check: snow-liquid ponds without the snow tracers
    are a configuration error (ValueError); with them the column
    builds and routes the drained snow liquid into the ponds."""
    with pytest.raises(ValueError, match="snow_liquid_ponds"):
        ColumnPhysics(3, 4, use_snow_liquid_ponds=True, device="cpu")
    col = ColumnPhysics(3, 4, use_snow_liquid_ponds=True,
                        use_snow_tracers=True, device="cpu")
    assert col.use_snow_liquid_ponds


@pytest.fixture(scope="module")
def flag_base_warm():
    return _flag_run(C.ColumnConfig(), warm=True)


@pytest.mark.parametrize("scheme", ["cesm", "lvl", "topo"])
def test_pond_schemes_make_ponds(scheme, flag_base_warm):
    """`tests/test_flags.py::test_pond_schemes_make_ponds`: each pond
    scheme with the dEdd shortwave changes the warm run's answer and
    forms finite, non-negative ponds."""
    st, _ = _flag_run(C.ColumnConfig(pond_scheme=scheme, shortwave="dEdd"),
                      warm=True)
    _assert_differs(st, flag_base_warm[0], f"pond_scheme={scheme}")
    apnd = st.tracers["pondArea"].numpy()
    assert np.isfinite(apnd).all()
    assert apnd.max() > 0.0, f"{scheme} scheme formed no ponds"
    hpnd = st.tracers["pondDepth"].numpy()
    assert hpnd.min() >= 0.0 and np.isfinite(hpnd).all()
