"""The brine height, the vertical salinity and the biogeochemistry of the
column in the port: `column/brine.py`, `column/zsalinity.py`,
`column/bgc.py` (skeletal) and `column/zbgc.py` (vertical zBGC, with the
z-layer aerosols).

Part 1 holds each ported function against the JAX package's on the same
inputs (made from a seed with numpy), float64 on the CPU, every output
to LIMIT of its own max (`tests/test_torch_column_functions.py::_compare`),
and keeps the JAX test's own assertions: the ports of
`tests/test_bgc.py`, `tests/test_zaero.py` and
`tests/test_column.py::test_skl_bgc`.  The inputs are batches of
[NB, NCAT] columns with NBL bio layers over NI ice layers, the shapes of
the subdiv-2 sphere of `tests/test_torch_column_model.py`, so that the
JAX package's operations, run one by one, compile once for both files
in one process.  Part 2 ports the JAX tests that step a model (the 5 x 5
box) to the port alone, with their assertions; the two-step models and
the flag tests against `seaice_tpu` are in
`tests/test_torch_column_model.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu.column import brine as Jb, bgc as Jk, zbgc as Jz
from seaice_tpu.column import zsalinity as Js
from seaice_tpu.column.mushy import enthalpy_mush
from seaice_tpu_torch import config as C
from seaice_tpu_torch.column import brine, bgc, zbgc, zsalinity
from seaice_tpu_torch.column import constants as c
from seaice_tpu_torch.column.driver import ColumnPhysics
from seaice_tpu_torch.column.thermo_shared import salinity_profile
from seaice_tpu_torch.model import SeaIceModel
from seaice_tpu_torch.parallel.sharded import full_physics_inputs
from seaice_tpu_torch.testcases import box
from tests.test_torch_column_functions import _both, _compare

torch.set_num_threads(1)

F64 = torch.float64
LIMIT = 1e-12
NB, NCAT, NI, NBL = 162, 3, 4, 4
DT = 3600.0


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _compare_bgc(ref, got, limit=LIMIT):
    """`_compare` of every field but the carbon residual `cerror`, a sum
    of reaction terms that cancel to rounding: it is held to `limit` of
    the largest term it sums (the reactions' `react`, or the tracer
    concentrations of a transport step), as a residual is."""
    scale_of = "react" if hasattr(ref, "react") else "tracers"
    scale = float(np.abs(np.asarray(getattr(ref, scale_of))).max())
    err = float(np.abs(got.cerror.numpy() -
                       np.asarray(ref.cerror)).max())
    assert err <= limit * scale, ("cerror", err, scale)
    _compare(ref._replace(cerror=None), got._replace(cerror=None), limit)


def _profiles(rng=None, T=-5.0):
    """Mushy enthalpy and salinity profiles [NB, NCAT, NI]: the JAX
    tests' uniform -5 C column, or with rng a seeded spread of
    temperatures and salinities."""
    S = np.tile(salinity_profile(NI), (NB, NCAT, 1))
    Tin = np.full((NB, NCAT, NI), T)
    if rng is not None:
        S = S * rng.uniform(0.6, 1.4, (NB, NCAT, 1))
        Tin = rng.uniform(-20.0, -1.0, (NB, NCAT, NI))
    q = np.asarray(enthalpy_mush(jnp.asarray(Tin), jnp.asarray(S)))
    return q, S


def _micro_inputs(rng=None, hbr=1.2):
    q, S = _profiles(rng)
    shp = (NB, NCAT)
    if rng is None:
        return dict(zqin=q, zSin=S, sss=np.full(shp, 34.0),
                    sst=np.full(shp, -1.7), hbr_old=np.full(shp, hbr))
    return dict(zqin=q, zSin=S, sss=rng.uniform(30.0, 35.0, shp),
                sst=rng.uniform(-1.8, -1.0, shp),
                hbr_old=rng.uniform(0.01, 2.5, shp))


def _micro(m, x):
    return m.compute_micro_s_mushy(x["zqin"], x["zSin"], x["sss"],
                                   x["sst"], x["hbr_old"], NBL)


def _both_micro(x):
    a, t = _both(x)
    return _micro(Jb, a), _micro(brine, t)


# -- part 1: functions against seaice_tpu (tests/test_bgc.py) -------------

def test_micro_structure_matches_reference():
    """`TestBrine::test_micro_structure`: the brine microstructure of the
    -5 C column and of seeded columns equal to LIMIT; porosity in (0, 1],
    small positive permeability, no flux through the top interface, a
    mean ice density between pure ice and flooded mush."""
    rng = np.random.default_rng(0)
    for x in (_micro_inputs(), _micro_inputs(rng)):
        ref, ms = _both_micro(x)
        _compare(ref, ms, LIMIT)
    ref, ms = _both_micro(_micro_inputs())
    assert float(ms.bphin.min()) > 0.0
    assert float(ms.bphin.max()) <= 1.0
    assert float(ms.iphin[..., -1].min()) >= \
        float(ms.iphin[..., 1].max()) - 0.5
    assert 0.0 < float(ms.kperm.min()) < 1e-6
    assert float(ms.iDin.min()) >= 0.0
    assert float(ms.iDin[..., 0].abs().max()) == 0.0
    assert 850.0 < float(ms.sice_rho.mean()) < 1020.0


def _hbrine_inputs(rng):
    shp = (NB, NCAT)
    hin = rng.uniform(0.01, 3.0, shp)
    hin[rng.random(shp) < 0.2] = rng.uniform(0.0, 0.06)
    return dict(
        meltb=rng.uniform(0.0, 0.01, shp) * (rng.random(shp) < 0.5),
        meltt=rng.uniform(0.0, 0.02, shp) * (rng.random(shp) < 0.5),
        melts=rng.uniform(0.0, 0.01, shp) * (rng.random(shp) < 0.5),
        hin=hin, hsn=rng.uniform(0.0, 0.4, shp),
        hin_old=hin * rng.uniform(0.95, 1.05, shp),
        hbr_old=hin * rng.uniform(0.6, 1.2, shp),
        snoice=rng.uniform(0.0, 0.01, shp) * (rng.random(shp) < 0.3),
        dhS_bottom=rng.uniform(-0.01, 0.02, shp),
        kperm=rng.uniform(0.0, 1e-9, shp),
        bphin_top=rng.uniform(0.0, 0.5, shp),
        aice0=rng.uniform(0.0, 0.5, shp))


def _hbrine(m, x):
    return m.update_hbrine(DT, x["meltb"], x["meltt"], x["melts"], x["hin"],
                           x["hsn"], x["hin_old"], x["hbr_old"], x["snoice"],
                           x["dhS_bottom"], x["kperm"], x["bphin_top"],
                           x["aice0"])


def test_update_hbrine_matches_reference():
    """`TestBrine::test_update_hbrine_relaxes_to_sea_level`: seeded
    columns through every branch (thick above and below sea level, thin)
    equal to LIMIT; brine above sea level drains toward it, brine below
    floods upward."""
    rng = np.random.default_rng(1)
    x = _hbrine_inputs(rng)
    a, t = _both(x)
    _compare(_hbrine(Jb, a), _hbrine(brine, t), LIMIT)
    shp = (NB, NCAT)
    h_ocn = brine.RHOSI / 1026.0 * 1.5
    for hbr0, drains in ((h_ocn + 0.3, True), (h_ocn - 0.2, False)):
        x = {k: np.zeros(shp) for k in x}
        x.update(hin=np.full(shp, 1.5), hin_old=np.full(shp, 1.5),
                 hbr_old=np.full(shp, hbr0), kperm=np.full(shp, 2e-10),
                 bphin_top=np.full(shp, 0.2), aice0=np.full(shp, 0.1))
        a, t = _both(x)
        ref, got = _hbrine(Jb, a), _hbrine(brine, t)
        _compare(ref, got, LIMIT)
        if drains:
            assert float(got.hbr.max()) < hbr0
            assert float(got.hbr.min()) > h_ocn - 1e-6
            assert bool(torch.isfinite(got.fbri).all())
        else:
            assert float(got.hbr.min()) > hbr0


def test_preflushing_matches_reference():
    """`TestBrine::test_preflushing`: seeded inputs equal to LIMIT; the
    JAX test's column gives hin 1.5, dhbr_bot 0.01, hbr_old 1.495."""
    rng = np.random.default_rng(2)
    shp = (NB, NCAT)
    names = ("aicen", "vicen", "vsnon", "meltb", "meltt", "congel",
             "snoice", "hice_old", "fbri")
    x = dict(aicen=rng.uniform(0.0, 0.3, shp), vicen=rng.uniform(0.0, 1.0,
                                                                 shp),
             vsnon=rng.uniform(0.0, 0.1, shp),
             meltb=rng.uniform(0.0, 0.01, shp),
             meltt=rng.uniform(0.0, 0.01, shp),
             congel=rng.uniform(0.0, 0.02, shp),
             snoice=rng.uniform(0.0, 0.01, shp),
             hice_old=rng.uniform(0.0, 3.0, shp),
             fbri=rng.uniform(0.5, 1.2, shp))
    x["aicen"][rng.random(shp) < 0.2] = 0.0
    for inputs in (x, dict(zip(names, (np.full(shp, v) for v in (
            0.9, 1.35, 0.09, 0.01, 0.005, 0.02, 0.0, 1.495, 1.0))))):
        a, t = _both(inputs)
        got = brine.preflushing_changes(*(t[k] for k in names))
        _compare(Jb.preflushing_changes(*(a[k] for k in names)), got,
                 LIMIT)
    np.testing.assert_allclose(got.hin.numpy(), 1.5)
    np.testing.assert_allclose(got.dhbr_bot.numpy(), 0.01)
    np.testing.assert_allclose(got.hbr_old.numpy(), 1.495)


def _zsal(m, ms, x):
    return m.solve_zsalinity(DT, x["bS"], ms.iphin, ms.iDin, x["darcy"],
                             x["hbr"], x["hbr_old"], x["dh_bot"], x["dh_top"],
                             x["sss"], ms.brine_sal[..., -1])


def _zsal_both(x, micro):
    ref_ms, ms = _both_micro(micro)
    a, t = _both(x)
    ref, got = _zsal(Js, ref_ms, a), _zsal(zsalinity, ms, t)
    _compare(ref, got, LIMIT)
    return got


def _zsal_inputs(bS, rng=None, **kw):
    shp = (NB, NCAT)
    z = np.zeros(shp)
    x = dict(bS=np.full(shp + (NBL,), bS), darcy=z, hbr=np.full(shp, 1.0),
             hbr_old=np.full(shp, 1.0), dh_bot=z, dh_top=z,
             sss=np.full(shp, 34.0))
    if rng is not None:
        x.update(bS=rng.uniform(2.0, 14.0, shp + (NBL,)),
                 darcy=rng.uniform(-5e-5, 1e-6, shp) * (rng.random(shp) <
                                                         0.5),
                 hbr=rng.uniform(0.05, 2.5, shp),
                 dh_bot=rng.uniform(-0.02, 0.03, shp),
                 dh_top=rng.uniform(-0.01, 0.0, shp),
                 sss=rng.uniform(30.0, 35.0, shp))
        x["hbr_old"] = x["hbr"] - x["dh_bot"]
    x.update(kw)
    return x


def test_zsalinity_drains_toward_profile_matches_reference():
    """`TestZsalinity::test_salinity_drains_toward_profile`: the JAX
    test's 10 ppt column and seeded columns (flushing, growth, melt)
    equal to LIMIT; finite, above MIN_SALIN, the bottom layer gaining
    salt from the saltier ocean."""
    rng = np.random.default_rng(3)
    _zsal_both(_zsal_inputs(0.0, rng), _micro_inputs(rng))
    got = _zsal_both(_zsal_inputs(10.0), _micro_inputs(hbr=1.0))
    out = got.bSin.numpy()
    assert np.isfinite(out).all()
    assert out.min() >= 0.1 - 1e-12
    assert out[..., -1].mean() > 10.0
    assert bool(torch.isfinite(got.fzsal).all())


def test_zsalinity_growth_entrains_salt_matches_reference():
    """`TestZsalinity::test_growth_entrains_salt`: 2 cm of growth
    entrains ocean salt (more column salt than without growth), both
    runs equal to LIMIT."""
    grow = np.full((NB, NCAT), 0.02)
    micro = _micro_inputs(hbr=1.0)
    z_g = _zsal_both(_zsal_inputs(6.0, hbr=1.0 + grow, dh_bot=grow), micro)
    z_0 = _zsal_both(_zsal_inputs(6.0), micro)
    assert bool((z_g.zsal_tot > z_0.zsal_tot).all())


def _zbgc_setup(p, hbr=1.0):
    ref_ms, ms = _both_micro(_micro_inputs(hbr=hbr))
    C0 = np.broadcast_to(p.ocean_concentrations().numpy()[:, None],
                         (NB, NCAT, p.n_bio, NBL + 1))
    return ref_ms, ms, C0


def _zbgc_call(m, p, C0, ms, fsw, extra=None, **kw):
    """`zbgc_transport_react` of package m (the JAX package's `Jz` or the
    port's `zbgc`) on C0 and the microstructure ms, a still unit brine
    column under fsw W/m^2 unless kw says otherwise; extra: frac."""
    shp = (NB, NCAT)
    one = np.ones(shp)
    x = dict(C=C0, darcy=0 * one, hbr=one, hbr_old=one, dh_bot=0 * one,
             fsw=fsw * one, Tb=-1.8 * one)
    x.update(kw)
    x.update({k: v for k, v in (extra or {}).items()})
    a = {k: (jnp.asarray(v) if m is Jz else _t(v)) for k, v in x.items()}
    pm = _jax_params(p) if m is Jz else p
    return m.zbgc_transport_react(
        DT, a["C"], ms.iphin, ms.iDin, a["darcy"], a["hbr"], a["hbr_old"],
        a["dh_bot"], a["fsw"], a["Tb"], pm.ocean_concentrations(), pm,
        **{k: a[k] for k in (extra or {})})


def _jax_params(p):
    """The JAX package's ZbgcParams with the fields of the port's."""
    return Jz.ZbgcParams(**dataclasses.asdict(p))


def _zbgc_both(p, fsw, hbr=1.0, **kw):
    ref_ms, ms, C0 = _zbgc_setup(p, hbr)
    ref = _zbgc_call(Jz, p, C0, ref_ms, fsw, **kw)
    got = _zbgc_call(zbgc, p, C0, ms, fsw, **kw)
    _compare_bgc(ref, got)
    return got


def test_zbgc_growth_under_light_matches_reference():
    """`TestZbgc::test_growth_under_light`: the full roster (the JAX
    test's is the minimal one) from the ocean's concentrations under
    light and in the dark, equal to LIMIT; finite, non-negative, growth
    and chlorophyll under light, none in the dark."""
    p = _full_params()
    out = _zbgc_both(p, 20.0)
    assert bool(torch.isfinite(out.tracers).all())
    assert float(out.tracers.min()) >= 0.0
    assert float(out.pp_net.max()) > 0.0
    assert float(out.chla.max()) > 0.0
    dark = _zbgc_both(p, 0.0)
    assert float(dark.pp_net.max()) <= 1e-12


def _react_both(p, C, fsw, Tb, dt=3600.0):
    a, t = _both(dict(C=C, fsw=fsw, Tb=Tb))
    ref = Jz.algal_reactions(dt, a["C"], a["fsw"], a["Tb"], _jax_params(p))
    got = zbgc.algal_reactions(dt, t["C"], t["fsw"], t["Tb"], p)
    _compare_bgc(ref, got)
    return got


def test_nutrient_drawdown_and_uptake_ratio_matches_reference():
    """`TestZbgc::test_nutrient_drawdown_and_uptake_ratio`: the minimal
    roster's reactions (seeded and the JAX test's column) equal to LIMIT;
    nitrogen drawn down, silicate taken up in the R_Si2N ratio."""
    p = zbgc.ZbgcParams()
    rng = np.random.default_rng(4)
    shp = (NB, NCAT)
    _react_both(p, rng.uniform(0.0, 30.0, shp + (p.n_bio,)),
                rng.uniform(0.0, 60.0, shp), rng.uniform(-4.0, 0.5, shp))
    C = np.broadcast_to(np.array([1.0, 12.0, 1.0, 25.0]), shp + (4,))
    r = _react_both(p, C, np.full(shp, 50.0), np.full(shp, -1.8))
    react = r.react[0, 0].numpy()
    grow = float(r.grow[0, 0])
    assert grow > 0.0
    assert react[1] < 0.0 or react[2] < 0.0
    assert react[3] < 0.0
    np.testing.assert_allclose(-react[3], p.R_Si2N[0] * grow * 3600.0,
                               rtol=1e-6)


# TestFullEcosystem: the complete algal_dyn network

def _full_params():
    """The full roster (3 algal classes, every pool) with 3 z-aerosol
    bins: 19 tracers, the roster of the zBGC model case."""
    return zbgc.ZbgcParams(n_algae=3, use_C=True, use_DON=True, use_Fe=True,
                           use_DMS=True, use_PON=True, use_hum=True,
                           use_zaero=True, n_zaero=3)


def _full_state(p, rng=None):
    ix = p.index()
    Cv = np.zeros(p.n_bio)
    Cv[ix["N"]] = [1.0, 0.5, 0.3]
    Cv[ix["Nit"]] = 12.0
    Cv[ix["Am"]] = 1.0
    Cv[ix["Sil"]] = 25.0
    Cv[ix["DOC"]] = [16.2, 9.0]
    Cv[ix["DIC"]] = 1950.0
    Cv[ix["DON"]] = 12.9
    Cv[ix["Fed"]] = 0.4
    Cv[ix["Fep"]] = 2.0
    Cv[ix["DMSPd"]] = 0.1
    Cv[ix["DMS"]] = 0.1
    Cv[ix["PON"]] = 12.0
    C = np.broadcast_to(Cv, (NB, NCAT, p.n_bio)).copy()
    if rng is not None:
        C = C * rng.uniform(0.0, 2.0, C.shape)
    return C


def _full_react(p, C, fsw=40.0, Tb=-1.5):
    shp = (NB, NCAT)
    return _react_both(p, C, np.full(shp, fsw), np.full(shp, Tb))


def test_roster_indexing_matches_reference():
    """`TestFullEcosystem::test_roster_indexing`: the full roster's
    slots, ocean concentrations, tracer types and phase timescales equal
    the JAX package's."""
    full15 = zbgc.ZbgcParams(n_algae=3, use_C=True, use_DON=True,
                             use_Fe=True, use_DMS=True, use_PON=True)
    for p in (full15, _full_params(), zbgc.ZbgcParams()):
        pj = _jax_params(p)
        assert p.index() == pj.index() and p.n_bio == pj.n_bio
        assert np.array_equal(p.ocean_concentrations().numpy(),
                              np.asarray(pj.ocean_concentrations()))
        assert np.array_equal(p.tracer_types(), pj.tracer_types())
        for a, b in zip(p.phase_timescales(), pj.phase_timescales()):
            assert np.array_equal(a, b)
    assert full15.n_bio == 3 + 1 + 1 + 1 + 2 + 1 + 1 + 2 + 2 + 1
    assert _full_params().n_bio == full15.n_bio + 1 + 3
    assert full15.index()["N"] == slice(0, 3)
    assert len(full15.ocean_concentrations()) == full15.n_bio


def test_nitrogen_closure_matches_reference():
    """`TestFullEcosystem::test_nitrogen_closure`: the full roster's
    reactions equal to LIMIT (the JAX test's column and seeded ones); N
    across algae, Nit, Am and DON plus Zoo closes to roundoff."""
    p = _full_params()
    _full_react(p, _full_state(p, np.random.default_rng(5)))
    r = _full_react(p, _full_state(p))
    ix = p.index()
    react = r.react.numpy()
    dN = (react[..., ix["N"]].sum(-1) + react[..., ix["Nit"]].sum(-1) +
          react[..., ix["Am"]].sum(-1) + react[..., ix["DON"]].sum(-1))
    np.testing.assert_allclose(dN + r.zoo.numpy(), 0.0, atol=1e-12)


def test_carbon_closure_matches_reference():
    """`TestFullEcosystem::test_carbon_closure`: the carbon residual of
    the port equals the JAX package's (LIMIT) and stays under 1e-10."""
    p = _full_params()
    r = _full_react(p, _full_state(p))
    assert float(r.cerror.abs().max()) < 1e-10


def test_dms_chain_matches_reference():
    """`TestFullEcosystem::test_dms_chain`: DMSPd converts to DMS with
    yield y_sk_DMS over a day, equal to LIMIT."""
    p = zbgc.ZbgcParams(n_algae=1, use_DMS=True)
    ix = p.index()
    C = np.zeros((NB, NCAT, p.n_bio))
    C[..., ix["DMSPd"]] = 10.0
    C[..., ix["Nit"]] = 1.0
    shp = (NB, NCAT)
    r = _react_both(p, C, np.zeros(shp), np.full(shp, -1.8), dt=86400.0)
    react = r.react[0, 0].numpy()
    dDMSPd = react[ix["DMSPd"]][0]
    dDMS = react[ix["DMS"]][0]
    assert dDMSPd < 0.0
    np.testing.assert_allclose(dDMS, -p.y_sk_DMS * dDMSPd, rtol=1e-12)


def test_iron_limits_phaeocystis_matches_reference():
    """`TestFullEcosystem::test_iron_limits_phaeocystis`: scarce
    dissolved iron limits growth, both runs equal to LIMIT."""
    p = _full_params()
    C = _full_state(p)
    C_lo = C.copy()
    C_lo[..., p.index()["Fed"]] = 1e-4
    r_hi = _full_react(p, C)
    r_lo = _full_react(p, C_lo)
    assert float(r_lo.grow[0, 0]) < float(r_hi.grow[0, 0])


def _uniform_micro(iphin, iDin):
    """A brine microstructure of uniform porosity and diffusivity on the
    NBL + 1 interfaces (the JAX tests' hand-made columns)."""
    shp = (NB, NCAT, NBL + 1)
    return (type("MS", (), dict(iphin=jnp.full(shp, iphin),
                                iDin=jnp.full(shp, iDin))),
            type("MS", (), dict(iphin=torch.full(shp, iphin, dtype=F64),
                                iDin=torch.full(shp, iDin, dtype=F64))))


def test_transport_with_full_roster_matches_reference():
    """`TestFullEcosystem::test_transport_with_full_roster`: the full
    roster through transport and reactions (and with the mobile
    fraction) equal to LIMIT; finite, non-negative, chlorophyll under
    light, the carbon residual under 1e-8."""
    p = _full_params()
    C0 = np.broadcast_to(_full_state(p)[..., None],
                         (NB, NCAT, p.n_bio, NBL + 1))
    ref_ms, ms = _uniform_micro(0.2, 1e-6)
    out = None
    for extra in ({}, {"frac": np.full((NB, NCAT, p.n_bio), 0.7)}):
        ref = _zbgc_call(Jz, p, C0, ref_ms, 30.0, Tb=np.full((NB, NCAT),
                                                              -1.5),
                         extra=extra)
        got = _zbgc_call(zbgc, p, C0, ms, 30.0, Tb=np.full((NB, NCAT),
                                                            -1.5),
                         extra=extra)
        _compare_bgc(ref, got)
        if out is None:
            out = got
    assert bool(torch.isfinite(out.tracers).all())
    assert float(out.tracers.min()) >= 0.0
    assert float(out.chla.max()) > 0.0
    assert float(out.cerror.max()) < 1e-8


# TestFctTransport: the flux-corrected vertical transport

def test_fct_monotone_on_step_profile_matches_reference():
    """`TestFctTransport::test_fct_monotone_on_step_profile`: a step
    profile under strong flushing and a zero ocean, equal to LIMIT; the
    tracers no reaction touches (PON, humics, the z-aerosols) stay within
    [0, 10] (the full roster here: the JAX test's one-alga roster without
    ammonium and silicate has no other pools)."""
    p = _full_params()
    prof = np.zeros(NBL + 1)
    prof[:(NBL + 1) // 2] = 10.0
    C0 = np.broadcast_to(prof, (NB, NCAT, p.n_bio, NBL + 1))
    ref_ms, ms = _uniform_micro(0.3, 0.0)
    shp = (NB, NCAT)
    darcy = np.full(shp, -2e-5)
    ref = Jz.zbgc_transport_react(
        1800.0, jnp.asarray(C0), ref_ms.iphin, ref_ms.iDin,
        jnp.asarray(darcy), jnp.ones(shp), jnp.ones(shp),
        jnp.zeros(shp), jnp.zeros(shp), jnp.full(shp, -1.8),
        jnp.zeros((p.n_bio,)), _jax_params(p))
    got = zbgc.zbgc_transport_react(
        1800.0, _t(C0), ms.iphin, ms.iDin, _t(darcy),
        torch.ones(shp, dtype=F64), torch.ones(shp, dtype=F64),
        torch.zeros(shp, dtype=F64), torch.zeros(shp, dtype=F64),
        torch.full(shp, -1.8, dtype=F64), torch.zeros(p.n_bio, dtype=F64),
        p)
    _compare_bgc(ref, got)
    ix = p.index()
    passive = [ix["PON"].start, ix["hum"].start] + list(
        range(ix["zaero"].start, ix["zaero"].stop))
    res = got.tracers.numpy()
    assert np.isfinite(res).all()
    assert res[..., passive, :].min() >= -1e-12
    assert res[..., passive, :].max() <= 10.0 + 1e-9


def test_fct_sharper_than_upwind_matches_reference():
    """`TestFctTransport::test_fct_sharper_than_upwind`: the limited
    anti-diffusion of one upwind step, equal to LIMIT, is clearly less
    diffusive and stays within the local bounds."""
    K = 16
    x = np.linspace(0.0, 1.0, K)
    dx = 1.0 / (K - 1)
    dt = 1.0
    w = 0.3 * dx / dt
    exact0 = np.exp(-((x - 0.35) / 0.12) ** 2)
    low = exact0.copy()
    low[1:] = exact0[1:] - w * dt / dx * (exact0[1:] - exact0[:-1])
    exact = np.exp(-((x - 0.35 - w * dt) / 0.12) ** 2)
    a, t = _both(dict(old=exact0[None, :], low=low[None, :], w=[w]))
    # one compiled function: a shape of its own, op by op, would compile
    # each of its operations
    ref = jax.jit(lambda o, lo, ww: Jz._fct_antidiffusion(o, lo, ww, dt, dx))(
        a["old"], a["low"], a["w"])
    got = zbgc._fct_antidiffusion(t["old"], t["low"], t["w"], dt, dx)
    _compare(ref, got, LIMIT)
    out = got.numpy()[0]
    assert np.abs(out - exact).sum() < 0.7 * np.abs(low - exact).sum()
    assert out.min() >= -1e-12
    assert out.max() <= exact0.max() + 1e-9


def _salt0(x):
    return x["bS"].mean(-1) * x["hbr_old"] * c.RHOI * 1.0e-3


def test_zsal_adaptive_substeps_resolve_stiff_columns_matches_reference():
    """`TestFctTransport::test_zsal_adaptive_substeps_resolve_stiff_
    columns`: strong flushing in half the columns (more sub-steps there),
    equal to LIMIT; the salt budget closes to 1e-9."""
    darcy = np.zeros((NB, NCAT))
    darcy[::2] = -5e-5
    x = _zsal_inputs(6.0, darcy=darcy)
    got = _zsal_both(x, _micro_inputs(hbr=1.0))
    assert bool(torch.isfinite(got.bSin).all())
    np.testing.assert_allclose(got.zsal_tot.numpy() - _salt0(x),
                               -got.fzsal.numpy() * DT, rtol=1e-9,
                               atol=1e-12)


def test_salt_budget_closes_and_drainage_split_matches_reference():
    """`TestZsalConservation::test_salt_budget_closes_and_drainage_
    split`: column salt change == -fzsal dt; the gravity-drainage part
    pulls salt in from the saltier ocean and is no larger than the
    total exchange; equal to LIMIT."""
    x = _zsal_inputs(6.0)
    got = _zsal_both(x, _micro_inputs(hbr=1.0))
    np.testing.assert_allclose(got.zsal_tot.numpy() - _salt0(x),
                               -got.fzsal.numpy() * DT, rtol=1e-9,
                               atol=1e-12)
    fg, ft = got.fzsal_g.numpy(), got.fzsal.numpy()
    assert (fg <= 0.0).all()
    assert (np.abs(fg) <= np.abs(ft) + 1e-12).all()


def test_skl_and_z_bgc_mutually_exclusive():
    """`TestSkeletalAndMobility::test_skl_and_z_bgc_mutually_exclusive`:
    the reference's check raises ValueError in the port too."""
    with pytest.raises(ValueError, match="exclusive"):
        ColumnPhysics(2, 4, use_biogeochemistry=True,
                      use_skeletal_bgc=True, device="cpu")


def test_mobile_fraction_partitions_and_conserves_matches_reference():
    """`TestSkeletalAndMobility::test_mobile_fraction_partitions_and_
    conserves`: the mobile/stationary split under retention equal to
    LIMIT; retained tracers lose mobile share, purely mobile ones stay
    mobile, and another mobility type changes the answer (the full
    roster; the JAX test's has one alga)."""
    p = _full_params()
    rng = np.random.default_rng(0)
    shp = (NB, NCAT)
    C0 = rng.uniform(0.5, 4.0, shp + (p.n_bio, NBL + 1))
    ref_ms, ms = _uniform_micro(0.3, 1.0e-9)
    kw = dict(C=C0, hbr_old=np.full(shp, 0.98), dh_bot=np.full(shp, 0.02),
              extra={"frac": np.ones(shp + (p.n_bio,))})
    r = _zbgc_call(zbgc, p, C0, ms, 5.0, **kw)
    _compare_bgc(_zbgc_call(Jz, p, C0, ref_ms, 5.0, **kw), r)
    f = r.frac_new.numpy()
    assert np.isfinite(f).all() and (f >= 0).all() and (f <= 1).all()
    types = p.tracer_types()
    assert (f[..., types >= 0] < 1.0).all()
    assert np.allclose(f[..., types < 0], 1.0)
    p2 = dataclasses.replace(p, mobility_type_ammonium=2.0)
    r2 = _zbgc_call(zbgc, p2, C0, ms, 5.0, **kw)
    ix = p.index()["Am"].start
    assert not np.allclose(r2.frac_new.numpy()[..., ix], f[..., ix])


# tests/test_zaero.py

def test_roster_appends_zaero_slots():
    """`test_roster_appends_zaero_slots`: the z-aerosol slots come last,
    their mobility types from the BC and dust options, a zero ocean
    concentration; the same roster as the JAX package's."""
    p0 = zbgc.ZbgcParams(n_algae=1)
    pz = zbgc.ZbgcParams(n_algae=1, use_zaero=True, n_zaero=3)
    assert pz.n_bio == p0.n_bio + 3
    zsl = pz.index()["zaero"]
    assert zsl.stop - zsl.start == 3 and zsl.stop == pz.n_bio
    pz2 = zbgc.ZbgcParams(n_algae=1, use_zaero=True, n_zaero=3,
                          mobility_type_black_carbon1=0.5,
                          mobility_type_dust1=-1.0)
    t = pz2.tracer_types()
    assert t[zsl][0] == 0.5 and t[zsl][2] == -1.0
    assert np.array_equal(t, _jax_params(pz2).tracer_types())
    assert float(pz.ocean_concentrations()[zsl].sum()) == 0.0


def test_zaero_is_passive_in_the_reaction_network_matches_reference():
    """`test_zaero_is_passive_in_the_reaction_network`: the z-aerosol
    slots get exactly zero reaction and leave the network unchanged,
    equal to LIMIT."""
    p0 = zbgc.ZbgcParams(n_algae=1)
    pz = zbgc.ZbgcParams(n_algae=1, use_zaero=True, n_zaero=2)
    rng = np.random.default_rng(0)
    shp = (NB, NCAT)
    C0 = rng.uniform(0.1, 2.0, shp + (p0.n_bio,))
    Cz = np.concatenate([C0, rng.uniform(0.0, 1e-5, shp + (2,))], -1)
    fsw, Tb = np.full(shp, 20.0), np.full(shp, -1.8)
    r0 = _react_both(p0, C0, fsw, Tb)
    rz = _react_both(pz, Cz, fsw, Tb)
    np.testing.assert_allclose(rz.react[..., :p0.n_bio].numpy(),
                               r0.react.numpy(), rtol=1e-12)
    assert float(rz.react[..., p0.n_bio:].abs().max()) == 0.0


def test_namelist_maps_zaerosols():
    """`test_namelist_maps_zaerosols`: the port's namelist sets use_zaero
    as the JAX package's does."""
    from seaice_tpu_torch.namelist import config_from_namelist
    cfg, _ = config_from_namelist({
        "biogeochemistry": {"config_use_zaerosols": True,
                            "config_use_column_biogeochemistry": True}})
    assert cfg.column.zbgc_params.use_zaero is True


def test_bulk_and_z_aerosols_are_exclusive():
    """`test_bulk_and_z_aerosols_are_exclusive`: the reference's check
    raises ValueError in the port."""
    pz = zbgc.ZbgcParams(n_algae=1, use_zaero=True)
    with pytest.raises(ValueError, match="exclusive"):
        ColumnPhysics(2, 4, n_aerosols=2, use_biogeochemistry=True,
                      use_brine_height=True, zbgc_params=pz, device="cpu")


# tests/test_column.py::test_skl_bgc

def _skl_steps(m, st, fsw, n=48):
    shp = (NB, NCAT)
    if m is Jk:
        full = jnp.full
        res = None
        for _ in range(n):
            res = m.step_skl_bgc(3600.0, st, full(shp, 0.45),
                                 full(shp, 0.45) * 1.5, full(shp, fsw),
                                 full(shp, -1.8), full(shp, 5.0),
                                 full(shp, 10.0))
            st = res.state
        return res

    def full(shape, v):
        return torch.full(shape, v, dtype=F64)
    res = None
    for _ in range(n):
        res = m.step_skl_bgc(3600.0, st, full(shp, 0.45),
                             full(shp, 0.45) * 1.5, full(shp, fsw),
                             full(shp, -1.8), full(shp, 5.0),
                             full(shp, 10.0))
        st = res.state
    return res


def test_skl_bgc_matches_reference():
    """`tests/test_column.py::test_skl_bgc`: 48 hourly skeletal steps in
    spring light and in the polar night, equal to LIMIT; the bloom grows
    and draws nutrients down under light, mortality wins in the dark."""
    shp = (NB, NCAT)
    for fsw in (5.0, 0.0):
        ref = _skl_steps(Jk, Jk.init_skl_bgc(shp), fsw)
        got = _skl_steps(bgc, bgc.init_skl_bgc(shp), fsw)
        _compare(ref, got, LIMIT)
        if fsw:
            assert float(got.state.algalN.min()) > 0.16
            assert float(got.chlorophyll.min()) > 0.0
            assert float(got.state.NO3.max()) <= 5.0 + 1e-9
        else:
            assert float(got.state.algalN.mean()) < 0.16


# -- part 2: the JAX tests that step a model, on the port alone -------------

def _box_run(steps=2, faero=None, **col):
    """The JAX tests' model: the 5 x 5 box, 2 categories, 4 ice layers,
    4 bio layers, from `full_physics_inputs`, `steps` full-physics steps
    in f64 on the CPU.  Returns (model, state, diags)."""
    cfg = C.Config(
        run=C.RunConfig(dt=1800.0, n_categories=2, n_ice_layers=4),
        velocity=C.VelocitySolverConfig(
            elastic_subcycle_number=2, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=C.AdvectionConfig(),
        column=C.ColumnConfig(n_bio_layers=4, **col))
    mesh = box.box_test_mesh(5, 5)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=F64, device="cpu")
    area, vol, snow, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, F64, "cpu")
    state = model.init_state(area, vol, snow)
    state = state.replace(tracers=dict(state.tracers, **extra))
    forcing = box.box_forcing(mesh, 0.0, F64, "cpu")
    step = model.make_step()
    diags = None
    for _ in range(steps):
        state, diags = step(model.tensors, state, forcing, atm, ocn,
                            coszen=coszen, faero_atm=faero)
    return model, state, diags


def test_full_model_with_bgc():
    """`TestZbgc::test_full_model_with_bgc`: use_biogeochemistry through
    the model step: finite non-negative bio tracers, brine height where
    there is ice, finite chlorophyll in the BGC diagnostics."""
    model, state, diags = _box_run(ktherm=2, use_biogeochemistry=True)
    assert {"brineHeight", "bioTracers"} <= set(model.tree.names)
    for name in ("brineHeight", "bioTracers"):
        assert bool(torch.isfinite(state.tracers[name]).all()), name
    assert float(state.tracers["bioTracers"].min()) >= 0.0
    fb = state.tracers["brineHeight"].numpy()
    a = state.tracers["iceAreaCategory"].numpy()
    assert (fb[a > 1e-6] > 0.0).all()
    bgc_d = diags["column_fluxes"].bgc
    assert bgc_d is not None and "chla" in bgc_d
    assert bool(torch.isfinite(bgc_d["chla"]).all())


def test_zsalinity_in_model():
    """`TestZbgc::test_zsalinity_in_model`: solve_zsalinity with BL99:
    the prognostic salinity is carried, finite and above MIN_SALIN."""
    model, state, _ = _box_run(steps=1, ktherm=1, solve_zsalinity=True)
    assert "verticalSalinity" in model.tree.names
    vs = state.tracers["verticalSalinity"].numpy()
    assert np.isfinite(vs).all()
    assert vs.min() >= 0.1 - 1e-12


def test_skeletal_bgc_reachable_from_model_step():
    """`TestSkeletalAndMobility::test_skeletal_bgc_reachable_from_model_
    step`: the sklBgc pools exist, evolve, stay finite and non-negative,
    icy cells carry a live population; the skeletal diagnostics."""
    model, state, diags = _box_run(ktherm=2, use_skeletal_biochemistry=True)
    assert "sklBgc" in model.tree.names
    s = state.tracers["sklBgc"].numpy()
    a = state.tracers["iceAreaCategory"].numpy()
    assert np.isfinite(s).all() and s.min() >= 0.0
    assert (s[..., 0][a > 1e-6] > 0.0).all()
    bgc_d = diags["column_fluxes"].bgc
    assert "skl_pp" in bgc_d and "skl_chla" in bgc_d


def test_mobility_partitioning_in_model():
    """`TestSkeletalAndMobility::test_mobility_partitioning_in_model`:
    bioMobileFraction starts at 1 and departs from it through the model
    step, within [0, 1]."""
    model, state, _ = _box_run(ktherm=2, use_biogeochemistry=True)
    assert "bioMobileFraction" in model.tree.names
    f = state.tracers["bioMobileFraction"].numpy()
    a = state.tracers["iceAreaCategory"].numpy()
    assert np.isfinite(f).all()
    assert (f >= 0).all() and (f <= 1.0 + 1e-12).all()
    assert (f[a > 1e-6] < 1.0).any()


ZAERO = zbgc.ZbgcParams(n_algae=1, use_zaero=True, n_zaero=3)


def test_zaero_deposition_accumulates_in_the_ice():
    """`test_zaero.py::test_zaero_deposition_accumulates_in_the_ice`:
    deposition builds z-aerosol content in the ice over 3 steps; without
    it the slots stay empty."""
    zsl = ZAERO.index()["zaero"]
    nc = box.box_test_mesh(5, 5).n_cells
    out = {}
    for dep in (True, False):
        faero = torch.full((nc, 3), 1e-9, dtype=F64) if dep else None
        _, s, _ = _box_run(steps=3, faero=faero, ktherm=2,
                           use_biogeochemistry=True, shortwave="dEdd",
                           zbgc_params=ZAERO)
        bio = s.tracers["bioTracers"].numpy()
        out[dep] = bio.reshape(bio.shape[:-1] + (ZAERO.n_bio, 5))[
            ..., zsl, :]
        a = s.tracers["iceAreaCategory"].numpy()
    has = a > 0.01
    assert np.isfinite(out[True]).all()
    assert out[True][has].max() > 0.0
    assert out[False][has].max() == 0.0


def test_zaero_darkens_the_dedd_albedo():
    """`test_zaero.py::test_zaero_darkens_the_dedd_albedo`: z-aerosol
    mass in the bio grid lowers the dEdd albedo of snow-free ice through
    the mass-path coupling, in one model step."""
    model, state0, _ = _box_run(steps=0, ktherm=2, use_biogeochemistry=True,
                                shortwave="dEdd", zbgc_params=ZAERO)
    mesh = model.mesh
    zsl = ZAERO.index()["zaero"]
    _, _, _, _, atm, ocn, coszen = full_physics_inputs(
        mesh, model.cfg, F64, "cpu")
    tr = dict(state0.tracers)
    tr["snowVolumeCategory"] = torch.zeros_like(tr["snowVolumeCategory"])

    def albedo(load):
        bio = tr["bioTracers"]
        Cb = torch.zeros(bio.shape[:-1] + (ZAERO.n_bio, 5), dtype=F64)
        Cb[..., zsl, :] = load
        s = state0.replace(tracers=dict(tr, bioTracers=Cb.reshape(
            bio.shape)))
        _, d = model.make_step()(model.tensors, s,
                                 box.box_forcing(mesh, 0.0, F64, "cpu"),
                                 atm, ocn, coszen=coszen)
        return float(d["column_fluxes"].albedo_vis_dir.mean())

    clean, dirty = albedo(0.0), albedo(5e-4)
    assert dirty < clean, (dirty, clean)
