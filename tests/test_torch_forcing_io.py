"""The port's clock, forcing, file readers and writers, initial
conditions and checkpoints (`seaice_tpu_torch/forcing/`, `io/`,
`testcases/ic.py`, `namelist.py`) against the JAX package's, float64 on
the CPU: the clock and its alarms over a year, the interpolation and the
derived atmospheric fields (1e-13 relative), the subdiv-2 MPAS file of
`tests/mpas_fixture.py` read by both readers (equal), the mesh, forcing
and ice-state files written and read back, every initial condition
(equal), and checkpoints written by one package and read by the
other (bitwise)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaice_tpu_torch import config as C
from seaice_tpu_torch.model import SeaIceModel

from tests.mpas_fixture import write_icosahedral_mpas_file

torch.set_num_threads(1)
F64 = torch.float64
FORCING_RTOL = 1e-13


@pytest.fixture(scope="module")
def mesh_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mpas") / "mesh_icos2.nc")
    write_icosahedral_mpas_file(path, subdiv=2)
    return path


@pytest.fixture(scope="module")
def meshes(mesh_file):
    from seaice_tpu.io.mesh_reader import read_mpas_mesh as jread
    from seaice_tpu_torch.io.mesh_reader import read_mpas_mesh
    return read_mpas_mesh(mesh_file), jread(mesh_file)


def _column_cfg(jax_package=False, n_cat=3, n_ice=4):
    if jax_package:
        from seaice_tpu import config as J
    else:
        J = C
    return J.Config(
        run=J.RunConfig(dt=1800.0, n_categories=n_cat, n_ice_layers=n_ice),
        velocity=J.VelocitySolverConfig(
            elastic_subcycle_number=4, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=J.AdvectionConfig(),
        column=J.ColumnConfig(ktherm=2, shortwave="dEdd",
                              pond_scheme="lvl", kstrength=1))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


# -- clock and alarms ---------------------------------------------------------

def test_clock_and_alarms_match_reference_over_a_year():
    from seaice_tpu.forcing.clock import Alarm as JAlarm
    from seaice_tpu.forcing.clock import ModelClock as JClock
    from seaice_tpu_torch.forcing.clock import Alarm, ModelClock
    clocks = (ModelClock(year=3, seconds=86400.0 * 300),
              JClock(year=3, seconds=86400.0 * 300))
    alarms = [(Alarm(86400.0), JAlarm(86400.0)),
              (Alarm(5 * 86400.0, offset=3600.0),
               JAlarm(5 * 86400.0, offset=3600.0))]
    months, rings = set(), 0
    for _ in range(365 * 8 + 8):                # a year in 3-hour steps
        for c in clocks:
            c.advance(3 * 3600.0)
        t, j = clocks
        assert (t.year, t.seconds, t.day_of_year, t.seconds_today, t.month,
                t.year_fraction, t.timestamp()) == \
            (j.year, j.seconds, j.day_of_year, j.seconds_today, j.month,
             j.year_fraction, j.timestamp())
        for a, b in alarms:
            r = a.is_ringing(t)
            assert r == b.is_ringing(j)
            rings += r
        months.add(t.month)
    assert clocks[0].year == 4 and months == set(range(1, 13))
    assert rings > 200
    assert clocks[0].copy().timestamp() == clocks[0].timestamp()
    with pytest.raises(ValueError, match="noleap"):
        ModelClock(calendar="gregorian")


# -- forcing ------------------------------------------------------------------

def test_forcing_series_interpolation_matches_reference():
    from seaice_tpu.forcing.core import ForcingSeries as JSeries
    from seaice_tpu.forcing.core import monthly_times as jmonthly
    from seaice_tpu_torch.forcing.core import ForcingSeries, monthly_times
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(monthly_times(), jmonthly())
    times = np.sort(rng.uniform(0.0, 365 * 86400.0, 9))
    fields = {"a": rng.standard_normal((9, 40)),
              "b": rng.uniform(200.0, 300.0, (9, 40))}
    t, j = ForcingSeries(times, fields), JSeries(times, fields)
    for s in np.concatenate([[0.0, times[0], times[-1], 365 * 86400.0 - 1],
                             rng.uniform(-1e7, 8e7, 20)]):
        got, want = t.interpolate(s), j.interpolate(s)
        for k in fields:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("longwave", ["rosati_miyakoda",
                                      "parkinson_washington"])
def test_derive_atmos_fields_matches_reference(longwave):
    from seaice_tpu.forcing.core import derive_atmos_fields as jderive
    from seaice_tpu_torch.forcing.core import derive_atmos_fields
    rng = np.random.default_rng(1)
    n = 300
    six = {"airTemperature": rng.uniform(230.0, 290.0, n),
           "airSpecificHumidity": rng.uniform(1e-4, 2e-2, n),
           "uAirVelocity": rng.standard_normal(n) * 5,
           "vAirVelocity": rng.standard_normal(n) * 5}
    mon = {"cloudFraction": rng.uniform(0.0, 1.0, n),
           "precipitationRate": rng.uniform(0.0, 1e-5, n)}
    geo = {"lon": rng.uniform(0.0, 2 * np.pi, n),
           "lat": rng.uniform(-np.pi / 2, np.pi / 2, n),
           "ice_area": rng.uniform(0.0, 1.0, n),
           "tsfc_c": rng.uniform(-30.0, 0.0, n),
           "sst_c": rng.uniform(-1.8, 25.0, n)}
    for sec, doy in ((0.0, 1.0), (30_000.0, 172.0), (80_000.0, 355.0)):
        got = derive_atmos_fields(
            {k: torch.as_tensor(v) for k, v in six.items()},
            {k: torch.as_tensor(v) for k, v in mon.items()},
            *(torch.as_tensor(v) for v in geo.values()),
            torch.tensor(sec, dtype=F64), torch.tensor(doy, dtype=F64),
            longwave_type=longwave)
        want = jderive(six, mon, *(jnp.asarray(v) for v in geo.values()),
                       jnp.asarray(sec), jnp.asarray(doy),
                       longwave_type=longwave)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == F64
            assert _rel(got[k], want[k]) <= FORCING_RTOL, k
        assert float(got["shortwave_down"].max()) > 0.0


# -- files --------------------------------------------------------------------

MESH_FIELDS = ("vertices_on_cell", "n_edges_on_cell", "cells_on_vertex",
               "edges_on_cell", "cells_on_cell", "cells_on_edge",
               "vertices_on_edge", "edges_on_vertex", "x_cell", "y_cell",
               "z_cell", "x_vertex", "y_vertex", "z_vertex", "x_edge",
               "y_edge", "lat_cell", "lon_cell", "lat_vertex", "lon_vertex",
               "area_cell", "area_triangle", "kite_areas_on_vertex",
               "dv_edge", "dc_edge", "cell_vertices_at_vertex",
               "interior_vertex", "x_local", "y_local")


def test_mesh_reader_matches_reference(meshes):
    """The independent MPAS file read by both packages' readers."""
    mesh, jmesh = meshes
    assert mesh.n_cells == 162 and mesh.on_sphere
    for k in ("n_cells", "n_vertices", "n_edges", "max_edges",
              "vertex_degree", "on_sphere", "sphere_radius"):
        assert getattr(mesh, k) == getattr(jmesh, k), k
    for k in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(mesh, k), getattr(jmesh, k),
                                      err_msg=k)


def test_mesh_forcing_and_state_files_round_trip(meshes, tmp_path):
    from seaice_tpu_torch.forcing.core import ForcingSeries
    from seaice_tpu_torch.io import (init_state_from_file, read_ice_state,
                                     read_mpas_mesh, write_ice_state,
                                     write_mpas_mesh)
    from seaice_tpu_torch.io.forcing_reader import (read_forcing_series,
                                                    write_forcing_series)
    mesh = meshes[0]
    path = str(tmp_path / "mesh.nc")
    write_mpas_mesh(path, mesh)
    back = read_mpas_mesh(path)
    for k in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(back, k), getattr(mesh, k),
                                      err_msg=k)

    rng = np.random.default_rng(2)
    series = ForcingSeries(np.array([0.0, 1e5, 2e6]),
                           {"airTemperature": rng.standard_normal((3, 7))})
    write_forcing_series(str(tmp_path / "f.nc"), series)
    back = read_forcing_series(str(tmp_path / "f.nc"),
                               {"airTemperature": "t"})
    np.testing.assert_array_equal(back.times, series.times)
    np.testing.assert_array_equal(back.fields["t"],
                                  series.fields["airTemperature"])

    model = SeaIceModel(mesh, _column_cfg(), dtype=F64, device="cpu")
    nc, ncat = mesh.n_cells, 3
    area = rng.uniform(0.0, 0.3, (nc, ncat))
    tracers = dict(model.init_state(area, area * 2.0, area * 0.1).tracers)
    tracers["surfaceTemperature"] = torch.as_tensor(
        rng.uniform(-20.0, -1.0, (nc, ncat)))
    u = rng.standard_normal(mesh.n_vertices)
    for name in ("ic.nc", "ic.npz"):
        p = str(tmp_path / name)
        write_ice_state(p, tracers, u_velocity=u, v_velocity=-u)
        fields = read_ice_state(p)
        for k in ("iceAreaCategory", "iceEnthalpy", "surfaceTemperature"):
            np.testing.assert_array_equal(fields[k], tracers[k].numpy())
        state = init_state_from_file(model, p)
        for k, t in tracers.items():
            assert torch.equal(state.tracers[k], t), k
        assert torch.equal(state.velocity.u_velocity, torch.as_tensor(u))
        assert torch.equal(state.velocity.v_velocity, torch.as_tensor(-u))


# -- initial conditions -------------------------------------------------------

IC_CASES = {
    "uniform_ice": lambda ic, m: ic.uniform_ice(m, 3, 0.9, 1.2, 0.1,
                                                lat_north=55.0),
    "uniform_interior": lambda ic, m: ic.uniform_interior(m, 2, 0.8, 1.0),
    "circle_ice": lambda ic, m: ic.circle_ice(m, 1, radius_fraction=0.5),
    "random_coverage": lambda ic, m: ic.random_coverage(m, 3, seed=4),
    "special_cells": lambda ic, m: ic.special_cells(m, (3, 40, 161), 2),
    "cice_default": lambda ic, m: ic.cice_default(
        m, 5, 7, 1, air_temperature=np.linspace(-30.0, 5.0, m.n_cells),
        lat_north=50.0, lat_south=-50.0),
    "ridging_band": lambda ic, m: ic.ridging_band(m, 2, 1.5),
    "category_initial_profile": lambda ic, m: (
        *ic.category_initial_profile(5), *ic.category_initial_profile(
            3, kcatbound=1)),
}


@pytest.mark.parametrize("case", sorted(IC_CASES))
def test_initial_condition_matches_reference(meshes, case):
    from seaice_tpu.testcases import ic as jic
    from seaice_tpu_torch.testcases import ic
    mesh = meshes[0]
    got = IC_CASES[case](ic, mesh)
    want = IC_CASES[case](jic, mesh)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                              err_msg=k)
        else:
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("kind", ["cice_default", "uniform"])
def test_initial_state_from_setup_matches_reference(meshes, kind):
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.namelist import RunSetup as JSetup
    from seaice_tpu.namelist import initial_state_from_setup as jinit
    from seaice_tpu_torch.convert import flatten_arrays
    from seaice_tpu_torch.namelist import RunSetup, initial_state_from_setup
    mesh, jmesh = meshes
    kw = dict(initial_condition_type=kind, initial_ice_area=0.9,
              initial_ice_volume=1.2, initial_snow_volume=0.1,
              initial_latitude_north=55.0, initial_latitude_south=-55.0,
              initial_uvelocity=0.25)
    got = initial_state_from_setup(
        SeaIceModel(mesh, _column_cfg(), dtype=F64, device="cpu"),
        RunSetup(**kw))
    want = jinit(JModel(jmesh, _column_cfg(True), dtype=jnp.float64),
                 JSetup(**kw))
    g, w = flatten_arrays(got), flatten_arrays(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert float(np.abs(g["tracers.iceEnthalpy"]).max()) > 0.0
    assert float(g["velocity.u_velocity"].max()) == 0.25


# -- checkpoints --------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_state(meshes):
    from seaice_tpu.model import SeaIceModel as JModel
    from seaice_tpu.namelist import RunSetup as JSetup
    from seaice_tpu.namelist import initial_state_from_setup as jinit
    jmodel = JModel(meshes[1], _column_cfg(True), dtype=jnp.float64)
    return jinit(jmodel, JSetup(initial_latitude_north=50.0,
                                initial_latitude_south=-50.0,
                                initial_vvelocity=-0.1))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages_bitwise(reference_state, writer,
                                             tmp_path):
    """A checkpoint of either package loads into the other bitwise: the
    same npz keys, state.time and the clock metadata included."""
    from seaice_tpu.io.checkpoint import load_checkpoint as jload
    from seaice_tpu.io.checkpoint import save_checkpoint as jsave
    from seaice_tpu_torch.convert import flatten_arrays
    from seaice_tpu_torch.io.checkpoint import (load_checkpoint,
                                                save_checkpoint,
                                                state_from_arrays)
    want = flatten_arrays(reference_state)
    path = str(tmp_path / "restart.npz")
    meta = {"year": 2, "seconds": 1234.5}
    if writer == "reference":
        jsave(path, reference_state, meta)
        state, clock = load_checkpoint(path, device="cpu")
    else:
        save_checkpoint(path, state_from_arrays(want, device="cpu"), meta)
        state, clock = jload(path)
    got = flatten_arrays(state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (int(clock["year"]), float(clock["seconds"])) == (2, 1234.5)
    with np.load(path) as z:
        assert set(z.files) == {"velocity." + k for k in (
            "u_velocity", "v_velocity", "stress11", "stress22", "stress12",
            "solve_velocity_prev")} | {"time", "clock.year",
                                       "clock.seconds"} | {
            k for k in want if k.startswith("tracers.")}


def test_output_stream_and_restart_timestamp(tmp_path):
    from scipy.io import netcdf_file
    from seaice_tpu_torch.io import (OutputStream, read_restart_timestamp,
                                     write_restart_timestamp)
    assert read_restart_timestamp(str(tmp_path)) is None
    write_restart_timestamp(str(tmp_path), "0001-01-02_00:00:00")
    assert read_restart_timestamp(str(tmp_path)) == "0001-01-02_00:00:00"
    for name in ("out.nc", "out.npz"):
        path = os.path.join(tmp_path, name)
        st = OutputStream(path, {"nCells": 4})
        st.flush()                       # nothing written yet: no file
        assert not os.path.exists(path)
        st.write({"iceAreaCell": np.arange(4.0),
                  "cat": np.ones((4, 3))}, "0001-01-01_00:00:00")
        st.write({"iceAreaCell": np.arange(4.0) * 2,
                  "cat": np.zeros((4, 3))}, "0001-01-02_00:00:00")
        st.flush()
        if name.endswith(".nc"):
            nc = netcdf_file(path, "r", mmap=False)
            data = np.array(nc.variables["iceAreaCell"][:])
            cat = np.array(nc.variables["cat"][:])
            xtime = b"".join(nc.variables["xtime"][1]).decode().strip()
            nc.close()
        else:
            with np.load(path) as z:
                data, cat, xtime = z["iceAreaCell"], z["cat"], z["xtime"][1]
        assert data.shape == (2, 4) and cat.shape == (2, 4, 3)
        np.testing.assert_array_equal(data[1], np.arange(4.0) * 2)
        assert str(xtime) == "0001-01-02_00:00:00"
