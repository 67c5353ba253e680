"""Column physics of the port on its own: ports of the JAX package's
`tests/test_column.py` checks (BL99 energy conservation, growth/melt
sanity, ITD remap conservation, mushy relations and Picard solver,
ice strength, orbital geometry), same inputs and assertions, float64 on
the CPU."""

import numpy as np
import torch

from seaice_tpu_torch.column import constants as cc
from seaice_tpu_torch.column import itd
from seaice_tpu_torch.column.bl99 import temperature_changes
from seaice_tpu_torch.column.thermo_shared import (
    ice_enthalpy_from_temperature, ice_temperature_from_enthalpy,
    melting_temperature, salinity_profile, snow_enthalpy_from_temperature,
    snow_temperature_from_enthalpy)
from seaice_tpu_torch.column.vertical import thermo_vertical

torch.set_num_threads(1)
NI, NS = 7, 1


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def full(shape, value):
    return torch.full(shape, float(value), dtype=torch.float64)


def _profile_state(nb=4, T0=-5.0):
    """A plausible mid-winter column state, batched [nb]."""
    S = salinity_profile(NI)
    zSin = t(np.tile(S, (nb, 1)))
    Tmlt = melting_temperature(zSin)
    zTin = t(np.tile(np.linspace(T0, -2.0, NI), (nb, 1)))
    zqin = ice_enthalpy_from_temperature(zTin, Tmlt)
    zTsn = full((nb, NS), T0)
    zqsn = snow_enthalpy_from_temperature(zTsn)
    return zSin, zqin, zTin, zqsn, zTsn


def test_enthalpy_roundtrip():
    S = salinity_profile(NI)
    Tmlt = melting_temperature(t(S))
    T = t(np.linspace(-20.0, -0.5, NI))
    q = ice_enthalpy_from_temperature(T, Tmlt)
    T2 = ice_temperature_from_enthalpy(q, Tmlt)
    np.testing.assert_allclose(T2.numpy(), T.numpy(), atol=1e-8)
    qs = snow_enthalpy_from_temperature(t([-10.0]))
    np.testing.assert_allclose(
        float(snow_temperature_from_enthalpy(qs)[0]), -10.0, atol=1e-10)


def test_bl99_converges_and_conserves():
    nb = 4
    zSin, zqin, zTin, zqsn, zTsn = _profile_state(nb)
    dt = 3600.0
    hilyr = full((nb,), 1.5 / NI)
    hslyr = full((nb,), 0.1 / NS)
    einit = (hilyr[:, None] * zqin).sum(-1) + (hslyr[:, None] *
                                               zqsn).sum(-1)
    # cold clear night: strong radiative cooling
    res = temperature_changes(
        dt, rhoa=full((nb,), 1.3), flw=full((nb,), 180.0),
        potT=full((nb,), 253.0), Qa=full((nb,), 0.0005),
        shcoef=full((nb,), 10.0), lhcoef=full((nb,), 20.0),
        fswsfc=full((nb,), 0.0), fswint=full((nb,), 0.0),
        Sswabs=full((nb, NS), 0.0), Iswabs=full((nb, NI), 0.0),
        hilyr=hilyr, hslyr=hslyr, zqin=zqin, zTin=zTin,
        zqsn=zqsn, zTsn=zTsn, zSin=zSin, Tsf=full((nb,), -8.0),
        Tbot=full((nb,), -1.8), einit=einit)
    assert bool(res.converged.all()), "BL99 failed to converge"
    # energy conservation: d(column energy)/dt == net boundary flux
    enew = (hilyr[:, None] * res.zqin).sum(-1) + \
        (hslyr[:, None] * res.zqsn).sum(-1)
    lhs = ((enew - einit) / dt).numpy()
    rhs = (res.fcondtopn - res.fcondbot + res.fswint).numpy()
    np.testing.assert_allclose(lhs, rhs, atol=cc.FERRMAX)
    # cold forcing must cool the surface below the initial -8 C
    assert float(res.Tsf.max()) < -8.0
    # temperatures must remain physical
    assert float(res.zTin.max()) < 0.0
    assert float(res.zTin.min()) > -40.0


def test_thermo_vertical_growth_and_melt():
    nb = 2
    zSin, zqin, zTin, zqsn, zTsn = _profile_state(nb)
    dt = 3600.0
    aicen = t([0.9, 0.9])
    # column 0: polar night (growth); column 1: warm + sunny (melt)
    res = thermo_vertical(
        dt, aicen, aicen * 1.5, aicen * 0.1, t([-8.0, -1.0]), zqin, zqsn,
        zSin, flw=t([150.0, 340.0]), potT=t([248.0, 278.0]),
        Qa=t([0.0003, 0.004]), rhoa=full((nb,), 1.3),
        fsnow=full((nb,), 0.0),
        # fbot <= 0 is ocean heat melting the bottom; growth needs
        # fbot = 0 with conduction carrying heat up through the ice
        fbot=t([0.0, -40.0]), Tbot=full((nb,), -1.8),
        fswsfc=t([0.0, 150.0]), fswint=t([0.0, 30.0]),
        Sswabs=full((nb, NS), 0.0),
        Iswabs=t(np.stack([np.zeros(NI), np.full(NI, 30.0 / NI)])),
        shcoef=full((nb,), 10.0), lhcoef=full((nb,), 20.0))
    assert bool(res.converged.all())
    hin = res.hin.numpy()
    # growth column thickens (congelation), melt column thins
    assert float(res.congel[0]) > 0.0
    assert hin[0] > 1.5
    assert float(res.meltb[1]) > 0.0 or float(res.meltt[1]) > 0.0
    assert hin[1] < 1.5
    # freshwater flux: melting -> positive flux to ocean
    assert float(res.freshn[1]) > 0.0
    assert np.isfinite(res.fhocnn.numpy()).all()


def test_category_boundaries():
    h = itd.category_boundaries(5)
    assert h[0] == 0.0
    assert np.all(np.diff(h) > 0)
    # Lipscomb 2001 ncat=5 canonical values ~ [0, .64, 1.39, 2.47, 4.57, 9.3]
    np.testing.assert_allclose(h[1], 0.6445, atol=1e-3)
    np.testing.assert_allclose(h[5], 9.3338, atol=1e-3)


def test_linear_itd_remap_conserves():
    """Growth shifting ice between categories conserves area-integrated
    volume, energy, and snow."""
    rng = np.random.RandomState(3)
    nb, ncat = 16, 5
    h = itd.category_boundaries(ncat)
    mids = 0.5 * (h[:-1] + np.minimum(h[1:], 12.0))
    aicen0 = t(0.15 * rng.rand(nb, ncat))
    hicen0 = t(np.tile(mids, (nb, 1)))
    vicen0 = aicen0 * hicen0
    # growth: thickness increases ~2 cm in every category
    dh = t(0.02 + 0.01 * rng.rand(nb, ncat))
    vicen1 = aicen0 * (hicen0 + dh)
    vsnon = aicen0 * 0.05
    S = salinity_profile(NI)
    tsfc = t(-10.0 + 5 * rng.rand(nb, ncat))
    qin = ice_enthalpy_from_temperature(
        t(-8.0 + 4 * rng.rand(nb, ncat, NI)),
        melting_temperature(t(np.tile(S, (nb, ncat, 1)))))
    qsn = snow_enthalpy_from_temperature(t(-9.0 + 4 * rng.rand(nb, ncat, NS)))

    aicen2, vicen2, vsnon2, at, it_, st = itd.linear_itd_remap(
        h, aicen0, vicen0, aicen0, vicen1, vsnon,
        area_tracers={"surfaceTemperature": tsfc},
        ice_tracers={"iceEnthalpy": qin,
                     "iceSalinity": t(np.tile(S, (nb, ncat, 1)))},
        snow_tracers={"snowEnthalpy": qsn})

    np.testing.assert_allclose(vicen2.sum(-1).numpy(),
                               vicen1.sum(-1).numpy(), rtol=1e-12)
    np.testing.assert_allclose(vsnon2.sum(-1).numpy(),
                               vsnon.sum(-1).numpy(), rtol=1e-12)
    # ice energy conserved: sum over cat of v * mean(q)
    e0 = (vicen1[..., None] * qin).sum((-2, -1)).numpy()
    e1 = (vicen2[..., None] * it_["iceEnthalpy"]).sum((-2, -1)).numpy()
    np.testing.assert_allclose(e1, e0, rtol=1e-11)
    # snow energy conserved
    es0 = (vsnon[..., None] * qsn).sum((-2, -1)).numpy()
    es1 = (vsnon2[..., None] * st["snowEnthalpy"]).sum((-2, -1)).numpy()
    np.testing.assert_allclose(es1, es0, rtol=1e-10)
    # category thickness bounds respected where ice present
    a2 = aicen2.numpy()
    hic = vicen2.numpy() / np.maximum(a2, 1e-30)
    for n in range(ncat):
        sel = a2[:, n] > 1e-8
        if sel.any():
            assert (hic[sel, n] <= h[n + 1] + 0.05).all()
            assert (hic[sel, n] >= h[n] - 0.05).all()


def test_ice_strength():
    a = t([0.0, 0.5, 0.95, 1.0])
    v = t([0.0, 0.5, 2.0, 3.0])
    p = itd.ice_strength_hibler(a, v).numpy()
    assert p[0] == 0.0
    assert np.all(np.diff(p) > 0)
    np.testing.assert_allclose(p[3], 2.75e4 * 3.0, rtol=1e-12)


def test_mushy_relations_roundtrip():
    """Mushy liquidus/enthalpy/temperature relations are mutually
    consistent (reference ice_mushy_physics.F90)."""
    from seaice_tpu_torch.column import mushy

    T = t(np.linspace(-25.0, -0.5, 40))
    S = t(np.linspace(1.0, 10.0, 40))
    # T -> q -> T roundtrip
    q = mushy.enthalpy_mush(T, S)
    np.testing.assert_allclose(mushy.temperature_mush(q, S).numpy(),
                               T.numpy(), atol=1e-6)
    # liquidus roundtrip: S_br(T_liq(S)) == S
    sbr = t(np.linspace(5.0, 200.0, 50))
    sbr2 = mushy.liquidus_brine_salinity(mushy.liquidus_temperature(sbr))
    np.testing.assert_allclose(sbr2.numpy(), sbr.numpy(), rtol=1e-8)
    # physical sanity
    phi = mushy.liquid_fraction(T, S).numpy()
    assert (phi >= 0).all() and (phi <= 1).all()
    # colder -> less liquid
    phi_cold = float(mushy.liquid_fraction(t(-20.0), t(5.0)))
    phi_warm = float(mushy.liquid_fraction(t(-2.0), t(5.0)))
    assert phi_cold < phi_warm
    # conductivity between brine and fresh-ice values
    km = mushy.conductivity_mush(q, S).numpy()
    assert (km > 0.4).all() and (km < 2.5).all()
    # enthalpy of melting matches enthalpy at the liquidus temperature
    qm = mushy.enthalpy_of_melting(S)
    q_at_liq = mushy.enthalpy_mush(mushy.liquidus_temperature(S), S)
    np.testing.assert_allclose(qm.numpy(), q_at_liq.numpy(), rtol=1e-6)


def test_mushy_picard_solver():
    """Mushy Picard heat solve: converges for cold/melting x snow/bare
    columns with energy closure within ferrmax (reference picard_solver,
    ice_therm_mushy.F90:1128)."""
    from seaice_tpu_torch.column.mushy import enthalpy_mush
    from seaice_tpu_torch.column.mushy_solver import (
        temperature_changes_mushy)

    nb = 4
    S = salinity_profile(NI)
    zSin = t(np.tile(S, (nb, 1)))
    zTin = t(np.tile(np.linspace(-8.0, -2.0, NI), (nb, 1)))
    zqin = enthalpy_mush(zTin, zSin)
    zqsn = snow_enthalpy_from_temperature(full((nb, NS), -8.0))
    dt = 3600.0
    hilyr = full((nb,), 1.5 / NI)
    hslyr = t([0.1, 0.1, 0.0, 0.0])   # snow, snow, bare, bare
    res = temperature_changes_mushy(
        dt, rhoa=full((nb,), 1.3), flw=t([160.0, 320.0, 160.0, 340.0]),
        potT=t([250.0, 272.0, 250.0, 276.0]),
        Qa=t([3e-4, 3e-3, 3e-4, 4e-3]),
        shcoef=full((nb,), 10.0), lhcoef=full((nb,), 20.0),
        fswsfc=t([0.0, 50.0, 0.0, 120.0]),
        fswint=t([0.0, 10.0, 0.0, 25.0]),
        Sswabs=full((nb, NS), 0.0),
        Iswabs=t(np.stack([np.zeros(NI), np.full(NI, 10 / NI),
                           np.zeros(NI), np.full(NI, 25 / NI)])),
        hilyr=hilyr, hslyr=hslyr, zqin=zqin, zSin=zSin, zqsn=zqsn,
        Tsf=t([-10.0, -2.0, -10.0, -0.5]), Tbot=full((nb,), -1.8))
    assert bool(res.converged.all())
    # melting columns pin the surface at 0; cold columns cool below start
    tsf = res.Tsf.numpy()
    assert tsf[1] == 0.0 and tsf[3] == 0.0
    assert tsf[0] < -10.0 and tsf[2] < -10.0
    assert float(res.zTin.max()) <= 1e-9
    # energy closure
    hil, hsl = hilyr.numpy(), hslyr.numpy()
    lsnow = hsl > 1e-4
    e0 = (hil[:, None] * zqin.numpy()).sum(-1) + \
        (hsl[:, None] * zqsn.numpy()).sum(-1) * lsnow
    e1 = (hil[:, None] * res.zqin.numpy()).sum(-1) + \
        (hsl[:, None] * res.zqsn.numpy()).sum(-1) * lsnow
    lhs = (e1 - e0) / dt
    rhs = (res.fcondtopn - res.fcondbot).numpy() + \
        np.asarray([0.0, 10.0, 0.0, 25.0])
    assert (np.abs(lhs - rhs) < 2e-3).all()


def test_orbital_coszen():
    """Zenith geometry (reference ice_orbital.F90 analog): subsolar
    noon, polar night, and seasonal declination limits."""
    from seaice_tpu_torch.column.orbital import (compute_coszen,
                                                 solar_declination)
    # equinox (~day 80): declination near zero, noon at lon 0 ->
    # coszen ~ cos(lat)
    for latd in (0.0, 45.0, 70.0):
        cz, _ = compute_coszen(np.deg2rad(latd), 0.0, 80.0, 43200.0)
        np.testing.assert_allclose(float(cz), np.cos(np.deg2rad(latd)),
                                   atol=0.03)
    # midnight at lon 0, equator: sun below horizon
    cz, _ = compute_coszen(0.0, 0.0, 80.0, 0.0)
    assert float(cz) == 0.0
    # polar night: 80N in late December, all day dark
    secs = t(np.linspace(0.0, 86400.0, 25))
    cz, _ = compute_coszen(np.deg2rad(80.0), 0.0, 355.0, secs)
    assert float(cz.max()) == 0.0
    # midnight sun: 80N in late June, sun up all day
    cz, _ = compute_coszen(np.deg2rad(80.0), 0.0, 172.0, secs)
    assert float(cz.min()) > 0.0
    # declination bounds +-23.45 deg; distance factor ~3.4% annual swing
    decl, eccf = solar_declination(t(np.arange(1.0, 366.0)))
    assert abs(float(torch.rad2deg(decl).max()) - 23.45) < 0.3
    assert abs(float(torch.rad2deg(decl).min()) + 23.45) < 0.3
    assert 1.02 < float(eccf.max()) < 1.04 and \
        0.96 < float(eccf.min()) < 0.98
