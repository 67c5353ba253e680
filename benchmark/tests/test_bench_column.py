"""The column as a matter of configuration and traffic: a configuration
whose column is on makes the program's step run its column phases under
the traffic's column forcing, which is the same on the program's mesh and
on the reference's, follows the sun, and comes from a table made at
set-up; the dynamical-core cell's step is left as it was."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.harness.compare import Mapping
from benchmark.harness.manifest import Cell
from benchmark.harness.sides import Side
from benchmark.harness.window import run_window
from benchmark.reference import sphere

from .column import column_cell
from .small import SMALL

SEED = 31415926535897


def test_side_steps_the_column_phases():
    """A Side of the column configuration at subdivision 2, stepped by
    the window, runs `column.thermo` and `column.post` once a step, and
    BL99's Picard solve."""
    from seaice_tpu_torch.diagnostics import RECORDER
    c = column_cell()
    side = Side(c.config, c.traffic, SEED, "cpu", torch.float32)
    assert side.model.column is not None and side.column is not None
    side.step()
    side.check()
    before = RECORDER.snapshot()
    w = run_window(side, 0.5, SEED, 1)
    totals, counts, counters = RECORDER.snapshot()
    _, c0, k0 = before
    assert w.failed == 0 and w.steps >= 1, w.failures
    for name in ("step", "column.thermo", "column.post"):
        assert counts[name] - c0.get(name, 0) == w.steps, name
    assert counters["column.picard_calls"] - \
        k0.get("column.picard_calls", 0) > 0
    assert side.n_steps == 1 + w.steps
    assert "column_thermo_unconverged" in side.check()
    side.load(side.initial)
    assert side.n_steps == 0


def test_dycore_side_has_no_column_forcing():
    c = Cell("qu60_dycore.winter_caps")
    c.apply(SMALL)
    side = Side(c.config, c.traffic, SEED, "cpu", torch.float32)
    assert side.model.column is None and side.column is None
    assert list(side.check()) == ["finite_ice", "finite_velocity",
                                  "speed_below_3", "aice_at_most_1"]


def test_column_on_without_its_forcing_raises():
    c = column_cell()
    traffic = dict(c.traffic)
    del traffic["column_forcing"]
    with pytest.raises(ValueError, match="column_forcing"):
        Side(c.config, traffic, SEED, "cpu", torch.float32)


def test_column_forcing_is_the_same_on_both_meshes():
    """On the program's panel-ordered mesh and on the reference's sphere,
    matched by position, every field agrees to 1e-12."""
    from seaice_tpu_torch.mesh import icosahedral_mesh
    from seaice_tpu_torch.mesh.panels import panel_reorder
    traffic = column_cell().traffic
    prog, _ = panel_reorder(icosahedral_mesh(3), 3)
    ref = sphere.build(3)
    to_ref = Mapping(prog, ref)
    P = to_ref(inputs.column_forcing(prog, traffic, SEED, 7 * 3600.0))
    R = inputs.column_forcing(ref, traffic, SEED, 7 * 3600.0)
    assert set(P) == set(inputs.ATMOS + inputs.OCEAN) == set(R)
    for k in R:
        scale = max(np.abs(R[k]).max(), 1e-300)
        assert np.abs(P[k] - R[k]).max() <= 1e-12 * scale, k
    assert np.ptp(R["air_temperature"]) > 10.0
    assert R["sw_vis_dir"].max() > 0.0


def test_the_sides_table_is_the_references_sun():
    """The program's step n gets the sun that `ColumnInputs.at(n)` gives
    the reference, from the day's table (n past a day wraps round)."""
    c = column_cell()
    side = Side(c.config, c.traffic, SEED, "cpu", torch.float64)
    ref = sphere.build(c.config["mesh"]["subdivisions"])
    to_ref = Mapping(side.mesh, ref)
    col = side.column
    run = c.config["run"]
    start = inputs.start_seconds(c.traffic, run["dt"], SEED)
    ci = inputs.ColumnInputs(ref, c.traffic, SEED, run["dt"], start)
    assert col["inputs"].per_day == ci.per_day == 48
    for n in (0, 11, 47, 48, 59):
        i = n % ci.per_day
        prog = {k: getattr(col["atmos"][i], k).numpy()
                for k in inputs.ATMOS}
        prog.update({k: getattr(col["ocean"], k).numpy()
                     for k in inputs.OCEAN})
        prog["coszen"] = col["coszen"][i].numpy()
        got, want = to_ref(prog), ci.at(n)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= \
                1e-12 * max(np.abs(want[k]).max(), 1.0), (n, k)
    assert not np.array_equal(ci.at(0)["coszen"], ci.at(11)["coszen"])
    np.testing.assert_array_equal(ci.at(59)["coszen"], ci.at(11)["coszen"])


def test_polar_night_and_the_subsolar_noon():
    """coszen is 0 at every hour of 1 January north of 68 N, and within
    1e-3 of 1 at the subsolar point at its local noon."""
    traffic = column_cell().traffic
    lat = torch.deg2rad(torch.linspace(68.0, 90.0, 23, dtype=torch.float64))
    lat = lat.repeat_interleave(36)
    lon = torch.deg2rad(torch.arange(0.0, 360.0, 10.0,
                                     dtype=torch.float64)).repeat(23)
    hours = [3600.0 * h for h in range(24)]
    s = inputs.sun(lat, lon, hours, traffic)
    assert s["coszen"].shape == (24, len(lat))
    assert (s["coszen"] == 0).all()
    for k in inputs.SW_SHARES:
        assert (s[k] == 0).all()
    for t in (0.0, 5 * 3600.0, 13.5 * 3600.0):
        day = 1.0
        decl = math.radians(23.44) * math.sin(2 * math.pi * (284 + day) /
                                              365)
        noon_lon = math.pi - 2 * math.pi * t / 86400.0
        p = inputs.sun(torch.tensor([decl], dtype=torch.float64),
                       torch.tensor([noon_lon], dtype=torch.float64),
                       [t], traffic)
        assert abs(float(p["coszen"][0, 0]) - 1.0) < 1e-3
        total = sum(float(p[k][0, 0]) for k in inputs.SW_SHARES)
        assert total == pytest.approx(
            inputs.SOLAR_CONSTANT * (1 + 0.033 * math.cos(
                2 * math.pi / 365)) *
            traffic["column_forcing"]["shortwave_transmissivity"],
            rel=1e-3)
