"""The port's namelist module (`seaice_tpu_torch/namelist.py`) against the
JAX package's: the Fortran-namelist parser, `config_from_namelist` on the
example namelist and on a namelist that sets every supported option of
the Registry table to a non-default legal value (equal `Config` and
`RunSetup`, field by field, enums by value), the hard errors, the audit
table and its summary, and the MPAS duration parser.  All host Python:
no JAX computation runs."""

import dataclasses
import enum
import os

import pytest

import seaice_tpu.namelist as J
import seaice_tpu_torch.namelist as T

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(HERE, "..", "examples", "namelist.seaice.example")


def _plain(x):
    """A Config, RunSetup or ZbgcParams as nested dicts of plain values,
    enums by value (the two packages' enum classes differ)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _both(source):
    (cj, sj), (ct, st) = J.config_from_namelist(source), \
        T.config_from_namelist(source)
    return _plain(cj), _plain(sj), _plain(ct), _plain(st)


SYNTAX = [
    """
&seaice_model
    config_dt = 1800.0
    config_calendar_type = 'gregorian_noleap'  ! comment
/
&velocity_solver
    config_elastic_subcycle_number = 60,
    config_use_air_stress = .false.
    config_slow = 5.0d-8
/
""",
    "&Seaice_Model\n  CONFIG_DT = 3600\n  config_start_time = \"2001-02-03\"\n"
    "/\n&end_record\n  config_x = T\n  config_y = f\n  config_z = 1.5D2\n/\n",
    "! only comments\n\n&empty\n/\n&a\n config_v = word\n  config_w = -2\n"
    "$end\n",
]


@pytest.mark.parametrize("case", range(len(SYNTAX)))
def test_parse_namelist_matches_reference(case):
    assert T.parse_namelist(SYNTAX[case]) == J.parse_namelist(SYNTAX[case])


@pytest.mark.parametrize("text", [
    "&a\n config_x = 1\n&b\n/\n",          # record not closed
    "config_x = 1\n",                       # outside a record
    "&a\n config_x 1\n/\n",                 # no '='
    "&a\n config_x = 1\n"])                 # not closed at end
def test_parse_namelist_syntax_errors(text):
    with pytest.raises(J.NamelistError):
        J.parse_namelist(text)
    with pytest.raises(T.NamelistError):
        T.parse_namelist(text)


def test_example_namelist_gives_the_reference_config():
    cj, sj, ct, st = _both(EXAMPLE)
    assert ct == cj and st == sj
    assert ct["column"]["use_ice_age"] and ct["column"]["use_first_year_ice"]
    assert st["run_duration"] == "00-00-00_06:00:00"


def _enum_keys(conv):
    """The legal namelist values of an `_enum` converter."""
    return sorted(conv.__closure__[0].cell_contents)


# the one row where the port's table differs from the JAX package's:
# supported in the port, which runs the skeletal scheme (ROADMAP Queue 3,
# fault 9); unsupported in the JAX table
SKELETAL = ("biogeochemistry", "config_use_skeletal_biochemistry")


def _every_option_namelist():
    """{record: {option: value}}: every option supported by both tables at
    a non-default legal value, where it has one (one pond scheme on, the
    topographic one)."""
    records = {}
    for o in T._TABLE:
        if o.disposition != "supported" or (o.record, o.full_name) == \
                SKELETAL:
            continue
        d = o.default
        if isinstance(d, bool):
            v = not d
        elif isinstance(d, int):
            v = d + 1
        elif isinstance(d, float):
            v = d * 1.5 + 0.25
        elif o.conv is not None:
            # an enum with one legal value keeps it
            keys = [k for k in _enum_keys(o.conv) if k != d] or [d]
            v = keys[0]
        else:
            v = d + "_x" if "time" not in o.name else "2001-02-03_04:05:06"
        records.setdefault(o.record, {})[o.full_name] = v
    ponds = {"config_use_cesm_meltponds": False,
             "config_use_level_meltponds": False,
             "config_use_topo_meltponds": True}
    for rec in records.values():
        for k in ponds:
            if k in rec:
                rec[k] = ponds[k]
    return records


def test_every_supported_option_gives_the_reference_config():
    """Every option both tables support, at a non-default value, parses to
    the reference's Config and RunSetup; the skeletal-BGC row, supported
    in the port alone, sets the port's option where the JAX parser
    refuses it."""
    records = _every_option_namelist()
    n = sum(len(r) for r in records.values())
    assert n == J.audit_summary()["supported"] == 251
    assert T.audit_summary()["supported"] == n + 1
    cj, sj, ct, st = _both(records)
    assert ct == cj and st == sj
    # the non-default values reached the config
    assert ct["column"]["pond_scheme"] == "topo"
    assert ct["column"]["zbgc_params"] is not None
    assert ct["run"]["dt"] != 3600.0
    skl = {SKELETAL[0]: {SKELETAL[1]: True}}
    cfg, _ = T.config_from_namelist(skl)
    assert cfg.column.use_skeletal_biochemistry is True
    with pytest.raises(J.NamelistError, match="not supported"):
        J.config_from_namelist(skl)


@pytest.mark.parametrize("text, match", [
    ("&seaice_model\n config_bogus = 1\n/\n", "unknown namelist option"),
    ("&seaice_model\n config_num_halos = 3\n/\n", "not supported"),
    ("&itd\n config_category_bounds_type = 'asymptotic'\n/\n",
     "not supported"),
    ("&column_tracers\n config_use_cesm_meltponds = .true.\n"
     " config_use_level_meltponds = .true.\n/\n", "pond")],
    ids=["unknown", "unsupported_value", "unsupported_enum", "two_ponds"])
def test_hard_errors_match_reference(text, match):
    with pytest.raises(J.NamelistError, match=match):
        J.config_from_namelist(text)
    with pytest.raises(T.NamelistError, match=match):
        T.config_from_namelist(text)


def test_audit_table_and_summary_match_reference():
    """The port's table is the JAX package's, row by row, but for the
    skeletal-BGC row (SKELETAL): supported in the port, unsupported in
    the JAX table; so one option moves from unsupported to supported."""
    assert J.audit_summary() == {
        "supported": 251, "na": 30, "unsupported": 35, "total": 316}
    assert T.audit_summary() == {
        "supported": 252, "na": 30, "unsupported": 34, "total": 316}
    rows_t, rows_j = list(T.audit_rows()), list(J.audit_rows())
    assert len(rows_t) == len(rows_j) == 316
    differ = []
    for t, j in zip(rows_t, rows_j):
        # record, option, disposition and default equal; a supported
        # option's target equal (the reasons name each package's files)
        assert (t[0], t[1], t[4]) == (j[0], j[1], j[4])
        if t[2] != j[2]:
            differ.append((t[0], t[1], j[2], t[2]))
        elif t[2] == "supported":
            assert t[3] == j[3]
    assert differ == [SKELETAL + ("unsupported", "supported")]
    assert set(T.REGISTRY) == set(J.REGISTRY)


@pytest.mark.parametrize("text, seconds", [
    ("00-00-00_06:00:00", 21600.0), ("00-00-01_00:00:00", 86400.0),
    ("1-00-02_00:00:30", 367 * 86400.0 + 30.0), ("03_01:00:00",
                                                3 * 86400.0 + 3600.0),
    ("12:30:05", 45005.0)])
def test_parse_duration_matches_reference(text, seconds):
    assert T._parse_duration(text) == J._parse_duration(text) == seconds


def test_month_durations_are_rejected():
    for mod in (J, T):
        with pytest.raises(mod.NamelistError, match="month"):
            mod._parse_duration("00-01-00_00:00:00")


def test_unported_model_options_parse_and_raise_when_built():
    """The z-salinity namelist (once an option the port's model left out,
    ROADMAP Queue 1 item 10e, ported since) parses to the reference's
    Config, and the model it configures (the 4 x 4 box from
    `full_physics_inputs`) builds and steps: one step, the vertical
    salinity and the brine height finite and moved, the z-salinity
    diagnostics in the column fluxes."""
    import numpy as np
    import torch
    from seaice_tpu_torch.model import SeaIceModel
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    from seaice_tpu_torch.testcases import box
    text = "&biogeochemistry\n config_use_vertical_zsalinity = .true.\n/\n"
    cj, sj, ct, st = _both(text)
    assert ct == cj and ct["column"]["solve_zsalinity"]
    cfg, _ = T.config_from_namelist(text)
    mesh = box.box_test_mesh(4, 4)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=torch.float64, device="cpu")
    assert {"brineHeight", "verticalSalinity"} <= set(model.tree.names)
    area, vol, snow, extra, atm, ocn, cz = full_physics_inputs(
        mesh, cfg, torch.float64, "cpu")
    s0 = model.init_state(area, vol, snow)
    s0 = s0.replace(tracers=dict(s0.tracers, **extra))
    s1, diags = model.make_step()(model.tensors, s0,
                                  box.box_forcing(mesh, 0.0, torch.float64,
                                                  "cpu"),
                                  atm, ocn, coszen=cz)
    for k in ("brineHeight", "verticalSalinity"):
        assert bool(torch.isfinite(s1.tracers[k]).all()), k
        assert not torch.equal(s1.tracers[k], s0.tracers[k]), k
    bgc = diags["column_fluxes"].bgc
    assert {"fzsal", "fzsal_g", "zsal_tot"} <= set(bgc)
    assert np.isfinite(bgc["zsal_tot"].numpy()).all()


def test_snow_grain_radius_prescribed_fluxes_namelist_builds_and_steps():
    """A namelist with the snow grain radius and calc_Tsfc=False (BL99)
    parses to the reference's Config, and the model it configures (a 4 x
    4 box from `full_physics_inputs`, the atmosphere model's surface
    fluxes seeded) builds and steps in both packages: one step (the JAX
    step op by op), u and v to 1e-11 of their max, every tracer to
    1e-12."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.parallel.sharded import full_physics_inputs as jinputs
    from seaice_tpu.testcases import box as jbox
    from seaice_tpu.utils.pytree import replace
    from seaice_tpu_torch.model import SeaIceModel as TModel
    from seaice_tpu_torch.parallel.sharded import full_physics_inputs
    from seaice_tpu_torch.testcases import box as tbox
    text = ("&dimensions\n config_nCategories = 3\n/\n"
            "&velocity_solver\n config_elastic_subcycle_number = 4\n/\n"
            "&thermodynamics\n config_thermodynamics_type = 'BL99'\n/\n"
            "&atmosphere\n config_calc_surface_temperature = .false.\n/\n"
            "&column_tracers\n config_use_snow_grain_radius = .true.\n/\n")
    cj, sj, ct, st = _both(text)
    assert ct == cj and ct["column"]["use_snow_tracers"]
    assert ct["column"]["ktherm"] == 1
    assert not ct["column"]["calc_surface_temperature"]
    (cfg_j, _), (cfg_t, _) = J.config_from_namelist(text), \
        T.config_from_namelist(text)
    mj, mt = jbox.box_test_mesh(4, 4), tbox.box_test_mesh(4, 4)
    mj.f_vertex = jbox.box_coriolis_parameter(mj)
    mt.f_vertex = tbox.box_coriolis_parameter(mt)
    J_ = JModel(mj, cfg_j, dtype=jnp.float64)
    T_ = TModel(mt, cfg_t, dtype=torch.float64, device="cpu")
    area, vol, snow, extra, atm, ocn, cz = jinputs(mj, cfg_j, jnp.float64)
    s_j = J_.init_state(area, vol, snow)
    s_j = replace(s_j, tracers=dict(s_j.tracers, **extra))
    area, vol, snow, extra_t, atm_t, ocn_t, cz_t = full_physics_inputs(
        mt, cfg_t, torch.float64, "cpu")
    s_t = T_.init_state(area, vol, snow)
    s_t = s_t.replace(tracers=dict(s_t.tracers, **extra_t))
    rng = np.random.default_rng(3)
    sfc = {k: rng.uniform(-20.0, 10.0, (mt.n_cells, 3))
           for k in ("fsurf", "fcondtop", "flat", "fsens")}
    s_j, _ = J_.make_step(jit=False)(
        J_.tensors, s_j, jbox.box_forcing(mj, t=0.0),
        jax.tree.map(jnp.asarray, atm), jax.tree.map(jnp.asarray, ocn),
        coszen=jnp.asarray(cz),
        sfc_fluxes={k: jnp.asarray(v) for k, v in sfc.items()})
    s_t, _ = T_.make_step()(
        T_.tensors, s_t, tbox.box_forcing(mt, 0.0, torch.float64, "cpu"),
        atm_t, ocn_t, coszen=cz_t,
        sfc_fluxes={k: torch.as_tensor(v) for k, v in sfc.items()})
    scale = np.abs(np.asarray(s_j.velocity.u_velocity)).max()
    assert scale > 1e-3
    for k in ("u_velocity", "v_velocity"):
        np.testing.assert_allclose(
            getattr(s_t.velocity, k).numpy(),
            np.asarray(getattr(s_j.velocity, k)), rtol=0,
            atol=1e-11 * scale, err_msg=k)
    assert set(s_t.tracers) == set(s_j.tracers)
    for k, w in s_j.tracers.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            s_t.tracers[k].numpy(), w, rtol=0,
            atol=1e-12 * max(np.abs(w).max(), 1e-300), err_msg=k)


def test_revised_evp_linear_ocean_stress_namelist_builds_and_steps():
    """A namelist with revised EVP and the linear ocean stress parses to
    the reference's Config, and the model it configures (the subdiv-2
    sphere, column package off) builds and steps in both packages: two
    steps, u and v to 1e-11 of their max, every tracer to 1e-12."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from seaice_tpu.dynamics.evp import DynamicsForcing as JForcing
    from seaice_tpu.mesh import icosahedral_mesh as jsphere
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu_torch.dynamics.evp import DynamicsForcing as TForcing
    from seaice_tpu_torch.mesh import icosahedral_mesh as tsphere
    from seaice_tpu_torch.model import SeaIceModel as TModel
    text = ("&seaice_model\n config_dt = 1800.0\n/\n"
            "&use_sections\n config_use_column_package = .false.\n/\n"
            "&velocity_solver\n config_elastic_subcycle_number = 6\n"
            " config_constitutive_relation_type = 'revised_evp'\n"
            " config_ocean_stress_type = 'linear'\n/\n")
    cj, sj, ct, st = _both(text)
    assert ct == cj
    assert ct["velocity"]["constitutive_relation"] == "evp_revised"
    assert ct["velocity"]["ocean_stress_type"] == "linear"
    (cfg_j, _), (cfg_t, _) = J.config_from_namelist(text), \
        T.config_from_namelist(text)
    mj, mt = jsphere(2), tsphere(2)
    J_ = JModel(mj, cfg_j, dtype=jnp.float64, build_unstructured=False)
    T_ = TModel(mt, cfg_t, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(9)
    nc, ncat = mt.n_cells, cfg_t.run.n_categories
    polar = np.abs(mt.lat_cell) > np.deg2rad(50.0)
    area = np.where(polar[:, None], rng.uniform(0.1, 0.19, (nc, ncat)), 0.)
    vol = area * rng.uniform(0.5, 3.0, (nc, ncat))
    f = dict(u_air_velocity=5.0 * rng.standard_normal(nc),
             v_air_velocity=5.0 * rng.standard_normal(nc),
             air_density=np.full(nc, 1.3),
             u_ocean_velocity=0.05 * rng.standard_normal(nc),
             v_ocean_velocity=0.05 * rng.standard_normal(nc),
             sea_surface_tilt_u=np.zeros(nc),
             sea_surface_tilt_v=np.zeros(nc), land_ice_mask=np.zeros(nc))
    s_j, s_t = J_.init_state(area, vol, area * 0.1), \
        T_.init_state(area, vol, area * 0.1)
    fj = JForcing(**{k: jnp.asarray(a) for k, a in f.items()})
    ft = TForcing(**{k: torch.as_tensor(a) for k, a in f.items()})
    step_j, step_t = jax.jit(J_.make_step(jit=False)), T_.make_step()
    for _ in range(2):
        s_j, _ = step_j(J_.tensors, s_j, fj)
        s_t, _ = step_t(T_.tensors, s_t, ft)
    scale = np.abs(np.asarray(s_j.velocity.u_velocity)).max()
    assert scale > 1e-3
    for k in ("u_velocity", "v_velocity"):
        np.testing.assert_allclose(
            getattr(s_t.velocity, k).numpy(),
            np.asarray(getattr(s_j.velocity, k)), rtol=0,
            atol=1e-11 * scale, err_msg=k)
    for k, w in s_j.tracers.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            s_t.tracers[k].numpy(), w, rtol=0,
            atol=1e-12 * max(np.abs(w).max(), 1e-300), err_msg=k)
