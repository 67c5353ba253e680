"""The port's column functions against the JAX package's: the same inputs
(a few hundred columns made from a seed with numpy) go through
`seaice_tpu.column.*` and `seaice_tpu_torch.column.*` in float64 on the
CPU, and every output is compared as max|port - ref| / max|ref|.

Limits: 1e-12 for the direct functions; 1e-10 for the two iterative heat
solvers (BL99 and the mushy Picard solver, and the vertical driver that
runs them), whose `converged` masks must also be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu import column as J
from seaice_tpu_torch import column as T
from seaice_tpu_torch.column import (atmo, bl99, dedd, itd,  # noqa: F401
                                     itd_thermo, mushy, mushy_solver,
                                     orbital, ponds, ridging, shortwave,
                                     vertical)

torch.set_num_threads(1)

LIMIT = 1e-12
SOLVER_LIMIT = 1e-10
NB, NCAT, NI, NS = 300, 5, 7, 1


def _leaves(x, prefix=""):
    """{name: numpy array} of every array in a (nested) result."""
    if x is None or isinstance(x, (int, float, str)):
        return {}
    if isinstance(x, torch.Tensor):
        return {prefix: x.detach().numpy()}
    if hasattr(x, "_fields"):
        return {k: v for f in x._fields
                for k, v in _leaves(getattr(x, f), f"{prefix}.{f}").items()}
    if dataclasses.is_dataclass(x):
        return {k: v for f in dataclasses.fields(x)
                for k, v in _leaves(getattr(x, f.name),
                                    f"{prefix}.{f.name}").items()}
    if isinstance(x, dict):
        return {k: v for key, val in x.items()
                for k, v in _leaves(val, f"{prefix}.{key}").items()}
    if isinstance(x, (tuple, list)):
        return {k: v for i, val in enumerate(x)
                for k, v in _leaves(val, f"{prefix}.{i}").items()}
    return {prefix: np.asarray(x)}


def _compare(ref, got, limit):
    """Every array of `ref` against the same one of `got`; returns the
    worst relative error and checks the boolean masks are equal."""
    r, g = _leaves(ref), _leaves(got)
    assert set(r) == set(g), (sorted(r), sorted(g))
    worst = 0.0
    for k, a in r.items():
        b = g[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype == bool:
            assert np.array_equal(a, b), k
            continue
        assert b.dtype == np.float64, (k, b.dtype)
        scale = float(np.abs(a).max()) if a.size else 0.0
        err = float(np.abs(b - a).max()) if a.size else 0.0
        rel = err / scale if scale > 0 else err
        assert rel <= limit, (k, rel)
        worst = max(worst, rel)
    return worst


def _both(arrays):
    """The same numpy inputs as jax arrays and as torch tensors."""
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in arrays.items()})


def _state(rng, nb=NB, ncat=NCAT, ni=NI, ns=NS):
    """A plausible ice state: categories with and without ice, enthalpy
    and salinity profiles, snow; a few empty and sliver categories."""
    hmax = J.itd.category_boundaries(ncat)
    mids = 0.5 * (hmax[:-1] + np.minimum(hmax[1:], 10.0))
    aicen = rng.uniform(0.0, 0.95 / ncat, (nb, ncat))
    aicen[rng.random((nb, ncat)) < 0.15] = 0.0
    aicen[rng.random((nb, ncat)) < 0.03] = 1e-12
    hin = mids * rng.uniform(0.7, 1.3, (nb, ncat))
    vicen = aicen * hin
    hsn = rng.uniform(0.0, 0.3, (nb, ncat))
    hsn[rng.random((nb, ncat)) < 0.3] = 0.0
    vsnon = aicen * hsn
    S = J.thermo_shared.salinity_profile(ni)
    sal = np.tile(S, (nb, ncat, 1)) * rng.uniform(0.8, 1.2, (nb, ncat, 1))
    Tin = rng.uniform(-25.0, -2.0, (nb, ncat, 1)) * \
        np.linspace(1.0, 0.1, ni) - 1.8 * np.linspace(0.0, 0.9, ni)
    Tin = np.minimum(Tin, -0.054 * sal - 0.05)
    qin = np.asarray(J.thermo_shared.ice_enthalpy_from_temperature(
        jnp.asarray(Tin), jnp.asarray(-0.054 * sal)))
    Tsn = rng.uniform(-25.0, -1.0, (nb, ncat, ns))
    qsn = np.asarray(J.thermo_shared.snow_enthalpy_from_temperature(
        jnp.asarray(Tsn)))
    tsfc = np.minimum(Tin[..., 0] - rng.uniform(0.0, 5.0, (nb, ncat)), 0.0)
    has = aicen > 0
    return dict(aicen=aicen, vicen=vicen, vsnon=vsnon,
                qin=qin * has[..., None], sin=sal * has[..., None],
                qsn=qsn * has[..., None], tsfc=tsfc * has, Tin=Tin,
                hmax=hmax)


def _forcing(rng, nb=NB):
    """Cell atmosphere/ocean forcing, from polar night to melt."""
    return dict(
        potT=rng.uniform(240.0, 276.0, nb), Qa=rng.uniform(2e-4, 4e-3, nb),
        rhoa=rng.uniform(1.2, 1.4, nb), flw=rng.uniform(150.0, 330.0, nb),
        uatm=rng.normal(0.0, 6.0, nb), vatm=rng.normal(0.0, 6.0, nb),
        zlvl=np.full(nb, 10.0), sw=rng.uniform(0.0, 200.0, (4, nb)),
        coszen=rng.uniform(0.0, 1.0, nb), sss=rng.uniform(30.0, 35.0, nb),
        sst=rng.uniform(-1.8, 1.0, nb), Tf=np.full(nb, -1.8),
        frzmlt=rng.uniform(-200.0, 200.0, nb))


# -- one case per module: (reference call, port call, limit) -------------

def case_itd(rng):
    s = _state(rng)
    s2 = dict(s)
    s2["vicen"] = s["vicen"] * rng.uniform(0.9, 1.1, s["vicen"].shape)
    a, t = _both(dict(aicen0=s["aicen"], vicen0=s["vicen"],
                      aicen=s["aicen"], vicen=s2["vicen"],
                      vsnon=s["vsnon"], tsfc=s["tsfc"], qin=s["qin"],
                      sin=s["sin"], qsn=s["qsn"]))
    h = s["hmax"]

    def run(m, x):
        aice = x["aicen"].sum(-1)
        aice0 = (1.0 - aice).clip(0.0)
        remap = m.itd.linear_itd_remap(
            h, x["aicen0"], x["vicen0"], x["aicen"], x["vicen"],
            x["vsnon"], {"surfaceTemperature": x["tsfc"]},
            {"iceEnthalpy": x["qin"], "iceSalinity": x["sin"]},
            {"snowEnthalpy": x["qsn"]})
        clean = m.itd.cleanup_small_ice(
            x["aicen"], x["vicen"], x["vsnon"],
            {"surfaceTemperature": x["tsfc"]}, {"iceEnthalpy": x["qin"]},
            {"snowEnthalpy": x["qsn"]})
        return dict(
            remap=remap, clean=clean,
            rothrock=m.itd.ice_strength_rothrock(
                x["aicen"], x["vicen"], aice, aice0, h),
            hibler=m.itd.ice_strength_hibler(aice, x["vicen"].sum(-1)),
            agg=m.itd.aggregate_area(x["aicen"]))
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def case_ridging(rng):
    s = _state(rng)
    a, t = _both(dict(aicen=s["aicen"] * 1.08, vicen=s["vicen"] * 1.08,
                      vsnon=s["vsnon"], tsfc=s["tsfc"], qin=s["qin"],
                      sin=s["sin"], qsn=s["qsn"],
                      alvl=rng.uniform(0.3, 1.0, s["aicen"].shape),
                      conv=rng.uniform(-1e-6, 4e-6, NB),
                      shear=rng.uniform(0.0, 4e-6, NB)))

    def run(m, x):
        return m.ridging.ridge_ice(
            1800.0, s["hmax"], x["conv"].clip(0.0), x["shear"].clip(0.0),
            x["aicen"], x["vicen"], x["vsnon"],
            {"surfaceTemperature": x["tsfc"], "levelIceArea": x["alvl"]},
            {"iceEnthalpy": x["qin"], "iceSalinity": x["sin"]},
            {"snowEnthalpy": x["qsn"]})
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def case_mushy(rng):
    a, t = _both(dict(T=rng.uniform(-30.0, -0.1, (NB, NI)),
                      S=rng.uniform(0.5, 12.0, (NB, NI)),
                      Sbr=rng.uniform(1.0, 220.0, (NB, NI)),
                      phi=rng.uniform(0.0, 1.0, (NB, NI))))

    def run(m, x):
        mu = m.mushy
        q = mu.enthalpy_mush(x["T"], x["S"])
        return dict(q=q, T=mu.temperature_mush(q, x["S"]),
                    sbr=mu.liquidus_brine_salinity(x["T"]),
                    tl=mu.liquidus_temperature(x["Sbr"]),
                    phi=mu.liquid_fraction(x["T"], x["S"]),
                    k=mu.conductivity_mush(q, x["S"]),
                    qm=mu.enthalpy_of_melting(x["S"]),
                    rho=mu.density_brine(x["Sbr"]),
                    qphi=mu.enthalpy_mush_liquid_fraction(x["T"], x["phi"]))
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def _solver_inputs(rng, mushy):
    """One category's columns for a heat solver, with the layer
    temperatures and enthalpies the solver's caller derives."""
    s = _state(rng, ncat=1)
    f = _forcing(rng)
    hin = np.maximum(s["vicen"][:, 0] / np.maximum(s["aicen"][:, 0], 1e-11),
                     0.2)
    hsn = np.where(rng.random(NB) < 0.3, 0.0, rng.uniform(0.0, 0.4, NB))
    sal = s["sin"][:, 0] + 0.5
    Tin = np.minimum(s["Tin"][:, 0], -0.054 * sal - 0.05)
    if mushy:
        qin = np.asarray(J.mushy.enthalpy_mush(jnp.asarray(Tin),
                                               jnp.asarray(sal)))
    else:
        qin = np.asarray(J.thermo_shared.ice_enthalpy_from_temperature(
            jnp.asarray(Tin), jnp.asarray(-0.054 * sal)))
    Tsn = rng.uniform(-20.0, -0.5, (NB, NS))
    qsn = np.asarray(J.thermo_shared.snow_enthalpy_from_temperature(
        jnp.asarray(Tsn)))
    # the interior absorption fswint is what the snow and ice layers take
    Sswabs = rng.uniform(0.0, 5.0, (NB, NS)) * (hsn[:, None] > 0)
    Iswabs = rng.uniform(0.0, 20.0, NB)[:, None] * \
        rng.dirichlet(np.ones(NI), NB)
    return dict(
        rhoa=f["rhoa"], flw=f["flw"], potT=f["potT"], Qa=f["Qa"],
        shcoef=rng.uniform(5.0, 15.0, NB), lhcoef=rng.uniform(10.0, 30.0, NB),
        fswsfc=rng.uniform(0.0, 150.0, NB),
        fswint=Sswabs.sum(-1) + Iswabs.sum(-1), Sswabs=Sswabs,
        Iswabs=Iswabs,
        hilyr=hin / NI, hslyr=hsn / NS, zqin=qin, zTin=Tin, zSin=sal,
        zqsn=qsn, zTsn=Tsn,
        Tsf=np.where(rng.random(NB) < 0.2, 0.0,
                     rng.uniform(-30.0, -0.5, NB)),
        Tbot=np.full(NB, -1.8), sss=f["sss"],
        hpond=rng.uniform(0.0, 0.3, NB) * (rng.random(NB) < 0.5),
        apond=rng.uniform(0.0, 0.4, NB))


def case_bl99(rng):
    x = _solver_inputs(rng, mushy=False)
    l_snow = x["hslyr"] > 1e-4
    qsn0 = np.where(l_snow[:, None], x["zqsn"], -330.0 * 0.3337e6)
    x["zqsn"] = qsn0
    x["zTsn"] = np.where(l_snow[:, None], x["zTsn"], 0.0)
    x["einit"] = (x["hilyr"][:, None] * x["zqin"]).sum(-1) + \
        (x["hslyr"][:, None] * qsn0).sum(-1)
    a, t = _both(x)
    names = ("rhoa flw potT Qa shcoef lhcoef fswsfc fswint Sswabs Iswabs "
             "hilyr hslyr zqin zTin zqsn zTsn zSin Tsf Tbot einit").split()

    def run(m, y):
        return m.bl99.temperature_changes(3600.0, *(y[k] for k in names))
    return lambda: run(J, a), lambda: run(T, t), SOLVER_LIMIT


def case_mushy_solver(rng):
    a, t = _both(_solver_inputs(rng, mushy=True))
    names = ("rhoa flw potT Qa shcoef lhcoef fswsfc fswint Sswabs Iswabs "
             "hilyr hslyr zqin zSin zqsn Tsf Tbot").split()

    def run(m, y):
        ms = m.mushy_solver
        hin = y["hilyr"] * NI
        return dict(
            solve=ms.temperature_changes_mushy(
                3600.0, *(y[k] for k in names), sss=y["sss"],
                hpond=y["hpond"], apond=y["apond"]),
            flow=ms.explicit_flow_velocities(
                3600.0, y["zSin"], y["zTin"], y["Tsf"], y["Tbot"], y["sss"],
                None, y["hilyr"], hin),
            flood=ms.flood_ice(
                3600.0, y["hslyr"] * 3.0, hin, y["hslyr"] * 3.0, y["hilyr"],
                y["zqsn"], y["zqin"], y["zSin"],
                m.mushy.liquid_fraction(y["zTin"], y["zSin"]),
                m.mushy.liquidus_brine_salinity(y["zTin"]), y["sss"],
                m.mushy.enthalpy_brine(y["Tbot"])))
    return lambda: run(J, a), lambda: run(T, t), SOLVER_LIMIT


def _vertical_inputs(rng, ktherm):
    s = _state(rng)
    f = _forcing(rng)
    sal = s["sin"] + 0.5 * (s["aicen"][..., None] > 0)
    qin = s["qin"]
    if ktherm == 2:
        qin = np.asarray(J.mushy.enthalpy_mush(jnp.asarray(s["Tin"]),
                                               jnp.asarray(sal))) * \
            (s["aicen"][..., None] > 0)
    shp = s["aicen"].shape

    def pc(v):
        return v[:, None] * np.ones(shp)
    Sswabs = rng.uniform(0.0, 3.0, shp + (NS,))
    Iswabs = rng.uniform(0.0, 20.0, shp)[..., None] * \
        rng.dirichlet(np.ones(NI), shp)
    return dict(
        aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
        Tsf=s["tsfc"], zqin=qin, zqsn=s["qsn"], zSin=sal,
        flw=pc(f["flw"]), potT=pc(f["potT"]), Qa=pc(f["Qa"]),
        rhoa=pc(f["rhoa"]), fsnow=pc(rng.uniform(0.0, 2e-5, NB)),
        fbot=rng.uniform(-30.0, 0.0, shp), Tbot=pc(f["Tf"]),
        fswsfc=rng.uniform(0.0, 150.0, shp),
        fswint=Sswabs.sum(-1) + Iswabs.sum(-1), Sswabs=Sswabs,
        Iswabs=Iswabs,
        shcoef=rng.uniform(5.0, 15.0, shp),
        lhcoef=rng.uniform(10.0, 30.0, shp), sss=pc(f["sss"]),
        frain=pc(rng.uniform(0.0, 1e-5, NB)),
        apond=rng.uniform(0.0, 0.4, shp),
        hpond=rng.uniform(0.0, 0.3, shp) * (rng.random(shp) < 0.5))


def _vertical_case(rng, ktherm):
    x = _vertical_inputs(rng, ktherm)
    a, t = _both(x)
    pos = ("aicen vicen vsnon Tsf zqin zqsn zSin flw potT Qa rhoa fsnow "
           "fbot Tbot fswsfc fswint Sswabs Iswabs shcoef lhcoef").split()

    def run(m, y):
        kw = dict(ktherm=ktherm)
        if ktherm == 2:
            kw.update(sss=y["sss"], apond=y["apond"], hpond=y["hpond"])
        out = m.vertical.thermo_vertical(3600.0, *(y[k] for k in pos), **kw)
        aice = y["aicen"].sum(-1)
        etot = (y["vicen"][..., None] * y["zqin"]).sum((-2, -1)) / NI
        return dict(vertical=out, bottom=m.vertical.frzmlt_bottom_lateral(
            3600.0, aice, y["fbot"][:, 0] * 5.0, y["Tbot"][:, 0] + 1.0,
            y["Tbot"][:, 0], y["flw"][:, 0] * 0.0 + 0.1,
            y["flw"][:, 0] * 0.0 + 0.05, etot))
    return lambda: run(J, a), lambda: run(T, t), SOLVER_LIMIT


def case_vertical_bl99(rng):
    return _vertical_case(rng, 1)


def case_vertical_mushy(rng):
    return _vertical_case(rng, 2)


def case_atmo(rng):
    s = _state(rng)
    f = _forcing(rng)
    shp = s["aicen"].shape
    x = {k: f[k][:, None] * np.ones(shp)
         for k in ("potT", "uatm", "vatm", "zlvl", "Qa", "rhoa")}
    x["wind"] = np.sqrt(x["uatm"] ** 2 + x["vatm"] ** 2)
    x["Tsf"] = s["tsfc"]
    a, t = _both(x)

    def run(m, y):
        return dict(
            ice=m.atmo.atmo_boundary_layer(
                y["Tsf"], y["potT"], y["uatm"], y["vatm"], y["wind"],
                y["zlvl"], y["Qa"], y["rhoa"]),
            ocn=m.atmo.atmo_boundary_layer(
                y["Tsf"], y["potT"], y["uatm"], y["vatm"], y["wind"],
                y["zlvl"], y["Qa"], y["rhoa"], sfctype="ocn"),
            const=m.atmo.atmo_constant_coefficients(
                y["Tsf"], y["potT"], y["uatm"], y["vatm"], y["wind"],
                y["Qa"], y["rhoa"]))
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def case_itd_thermo(rng):
    s = _state(rng)
    f = _forcing(rng)
    x = dict(aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
             tsfc=s["tsfc"], qin=s["qin"], sin=s["sin"], qsn=s["qsn"],
             alvl=rng.uniform(0.3, 1.0, s["aicen"].shape),
             vlvl=rng.uniform(0.3, 1.0, s["aicen"].shape),
             apnd=rng.uniform(0.0, 0.5, s["aicen"].shape),
             frzmlt=f["frzmlt"] * 3.0, Tf=f["Tf"],
             rside=rng.uniform(0.0, 0.02, NB))
    a, t = _both(x)
    salin = J.thermo_shared.salinity_profile(NI)

    def run(m, y, sal):
        at = {"surfaceTemperature": y["tsfc"], "levelIceArea": y["alvl"],
              "pondArea": y["apnd"]}
        it_ = {"iceEnthalpy": y["qin"], "iceSalinity": y["sin"],
               "levelIceVolume": y["vlvl"]}
        return dict(
            new=m.itd_thermo.add_new_ice(
                1800.0, s["hmax"], y["aicen"], y["vicen"], at, it_,
                y["frzmlt"], y["Tf"], sal, dilute_ponds=True),
            lat=m.itd_thermo.lateral_melt(
                1800.0, y["aicen"], y["vicen"], y["vsnon"], y["qin"],
                y["qsn"], y["rside"]))
    return (lambda: run(J, a, salin),
            lambda: run(T, t, torch.as_tensor(salin)), LIMIT)


def _sw_inputs(rng):
    s = _state(rng)
    f = _forcing(rng)
    return s, dict(aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
                   tsfc=s["tsfc"], coszen=f["coszen"],
                   sw=f["sw"], alvl=rng.uniform(0.3, 1.0, s["aicen"].shape),
                   apnd=rng.uniform(0.0, 0.6, s["aicen"].shape),
                   hpnd=rng.uniform(0.0, 0.4, s["aicen"].shape) *
                   (rng.random(s["aicen"].shape) < 0.6))


def case_shortwave(rng):
    _, x = _sw_inputs(rng)
    a, t = _both(x)

    def run(m, y):
        return m.shortwave.shortwave_ccsm3(
            y["aicen"], y["vicen"], y["vsnon"], y["tsfc"], *y["sw"], NI, NS)
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def case_dedd(rng):
    _, x = _sw_inputs(rng)
    a, t = _both(x)

    def run(m, y):
        args = (y["aicen"], y["vicen"], y["vsnon"], y["tsfc"], y["coszen"],
                *y["sw"], NI, NS)
        return dict(
            ponds=m.dedd.shortwave_dedd(*args, apnd=y["apnd"] * y["alvl"],
                                        hpnd=y["hpnd"], R_ice=0.3,
                                        R_pnd=-0.2, kalg=0.6),
            hs0=m.dedd.shortwave_dedd(*args, hs0=0.03))
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def case_ponds(rng):
    s = _state(rng)
    f = _forcing(rng)
    shp = s["aicen"].shape
    x = dict(aicen=s["aicen"], vicen=s["vicen"], vsnon=s["vsnon"],
             qin=s["qin"], sin=s["sin"], tsfc=s["tsfc"],
             rfrac=0.15 + 0.7 * s["aicen"],
             meltt=rng.uniform(0.0, 0.02, shp) * (rng.random(shp) < 0.6),
             melts=rng.uniform(0.0, 0.01, shp) * (rng.random(shp) < 0.4),
             frain=rng.uniform(0.0, 1e-5, shp),
             Tair=f["potT"][:, None] * np.ones(shp),
             fsurfn=rng.uniform(-50.0, 100.0, shp),
             dhs=rng.uniform(-0.01, 0.01, shp),
             alvl=rng.uniform(0.3, 1.0, shp),
             apnd=rng.uniform(0.0, 0.6, shp),
             hpnd=rng.uniform(0.0, 0.4, shp) * (rng.random(shp) < 0.6),
             ipnd=rng.uniform(0.0, 0.1, shp) * (rng.random(shp) < 0.5),
             iage=rng.uniform(0.0, 1e7, shp))
    a, t = _both(x)
    pos = ("rfrac meltt melts frain Tair fsurfn dhs aicen vicen vsnon qin "
           "sin tsfc alvl apnd hpnd ipnd").split()

    def run(m, y):
        p = m.ponds
        return dict(
            hlid1=p.compute_ponds_lvl(1800.0, *(y[k] for k in pos)),
            hlid2=p.compute_ponds_lvl(1800.0, *(y[k] for k in pos),
                                      ktherm=2),
            cesm=p.compute_ponds_lvl(1800.0, *(y[k] for k in pos),
                                     frzpnd="cesm"),
            perm=p.brine_permeability(y["qin"] - 1.0, y["sin"] + 0.1),
            age=p.increment_age(1800.0, y["iage"], y["vicen"]),
            fy=p.update_first_year_area(265, y["alvl"], y["aicen"]))
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def case_orbital(rng):
    x = dict(lat=rng.uniform(-np.pi / 2, np.pi / 2, NB),
             lon=rng.uniform(-np.pi, np.pi, NB),
             day=rng.uniform(1.0, 365.0, NB),
             sec=rng.uniform(0.0, 86400.0, NB))
    a, t = _both(x)

    def run(m, y):
        return dict(
            cz=m.orbital.compute_coszen(y["lat"], y["lon"], y["day"],
                                        y["sec"]),
            decl=m.orbital.solar_declination(y["day"]))
    return lambda: run(J, a), lambda: run(T, t), LIMIT


def case_thermo_shared(rng):
    s = _state(rng)
    f = _forcing(rng)
    a, t = _both(dict(q=s["qin"], S=s["sin"] + 0.1, qs=s["qsn"],
                      Tsf=s["tsfc"], sss=f["sss"], potT=f["potT"],
                      rhoa=f["rhoa"], flw=f["flw"], Qa=f["Qa"],
                      sh=rng.uniform(5.0, 15.0, NB),
                      lh=rng.uniform(10.0, 30.0, NB)))

    def run(m, x):
        ts = m.thermo_shared
        Tsf = x["Tsf"][:, 0]
        return dict(
            Tin=ts.ice_temperature_from_enthalpy(x["q"] - 1.0,
                                                 -0.054 * x["S"]),
            Tsn=ts.snow_temperature_from_enthalpy(x["qs"]),
            flux=ts.surface_heat_flux(Tsf, x["flw"] * 0.3, x["rhoa"],
                                      x["flw"], x["potT"], x["Qa"],
                                      x["sh"], x["lh"]),
            dflux=ts.dsurface_heat_flux_dTsf(Tsf, x["rhoa"], x["sh"],
                                             x["lh"]),
            tf={o: ts.sea_freezing_temperature(x["sss"], o)
                for o in ("minus1p8", "linear_salt", "mushy")})
    return lambda: run(J, a), lambda: run(T, t), LIMIT


# the two driver configurations: BL99 with the CCSM3 shortwave, constant
# atmosphere coefficients and level-ice ponds feeding back on the ocean's
# freshwater; and the three package switches off (therm1 skipped)
DRIVER_CONFIGS = {
    "bl99_ccsm3": dict(ktherm=1, shortwave="ccsm3", atmbndy="constant",
                       pond_scheme="lvl",
                       include_pond_freshwater_feedback=True),
    "switches_off": dict(ktherm=1, use_shortwave=False,
                         use_vertical_thermodynamics=False,
                         use_itd_thermodynamics=False),
}


def _driver_case(rng, options):
    s = _state(rng)
    f = _forcing(rng)
    shp = s["aicen"].shape
    x = dict(iceAreaCategory=s["aicen"], iceVolumeCategory=s["vicen"],
             snowVolumeCategory=s["vsnon"], surfaceTemperature=s["tsfc"],
             iceEnthalpy=s["qin"], iceSalinity=s["sin"],
             snowEnthalpy=s["qsn"],
             levelIceArea=rng.uniform(0.3, 1.0, shp),
             levelIceVolume=rng.uniform(0.3, 1.0, shp),
             pondArea=rng.uniform(0.0, 0.5, shp),
             pondDepth=rng.uniform(0.0, 0.3, shp),
             pondLidThickness=rng.uniform(0.0, 0.05, shp))
    atm = dict(air_temperature=f["potT"], specific_humidity=f["Qa"],
               u_air=f["uatm"], v_air=f["vatm"], longwave_down=f["flw"],
               sw_vis_dir=f["sw"][0], sw_vis_dif=f["sw"][1],
               sw_ir_dir=f["sw"][2], sw_ir_dif=f["sw"][3],
               rain_rate=rng.uniform(0.0, 1e-5, NB),
               snow_rate=rng.uniform(0.0, 1e-5, NB), air_density=f["rhoa"],
               air_level_height=f["zlvl"])
    ocn = dict(sst=f["sst"], sss=f["sss"], freezing_temperature=f["Tf"],
               frzmlt=f["frzmlt"], mixed_layer_depth=np.full(NB, 20.0))
    (xa, xt), (aa, at), (oa, ot) = _both(x), _both(atm), _both(ocn)

    def run(m, tr, a, o, **kw):
        col = m.driver.ColumnPhysics(NCAT, NI, NS, **options, **kw)
        return col.step_thermodynamics(1800.0, tr, m.driver.AtmosForcing(**a),
                                       m.driver.OceanForcing(**o))
    return (lambda: run(J, xa, aa, oa),
            lambda: run(T, xt, at, ot, dtype=torch.float64, device="cpu"),
            SOLVER_LIMIT)


def case_driver_bl99_ccsm3(rng):
    return _driver_case(rng, DRIVER_CONFIGS["bl99_ccsm3"])


def case_driver_switches_off(rng):
    return _driver_case(rng, DRIVER_CONFIGS["switches_off"])


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}
# reference calls that compile faster as one jitted program than they
# dispatch op by op (dEdd, ridging and the vertical drivers do not)
JIT = {"atmo", "bl99", "itd", "itd_thermo", "mushy", "mushy_solver",
       "orbital", "ponds", "shortwave"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_column_function_matches_reference(name):
    rng = np.random.default_rng(sorted(CASES).index(name) + 11)
    ref, port, limit = CASES[name](rng)
    _compare(jax.jit(ref)() if name in JIT else ref(), port(), limit)


def test_solvers_converge_with_the_reference():
    """The solver cases exercise the loops: some columns take several
    iterations, and both packages stop with the same columns
    converged (compared mask by mask above)."""
    for name in ("bl99", "mushy_solver"):
        rng = np.random.default_rng(sorted(CASES).index(name) + 11)
        _, port, _ = CASES[name](rng)
        out = port()
        res = out["solve"] if isinstance(out, dict) else out
        assert res.iterations > 2, (name, res.iterations)
        assert bool(res.converged.all()), name
