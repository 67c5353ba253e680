"""The reference steps through the phases that the configuration names:
the dynamics phase is the reference's step as it was; a phase is found
by its file's name, so a cell that needs a new phase adds files and
entries only; and a cell whose configuration asks for physics that no
phase steps ends before the program is built."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness.manifest import Cell
from benchmark.harness.sides import reference_side
from benchmark.reference import model, transport, velocity
from benchmark.reference.dynamics import TRACERS, VELOCITY

from .column import CELL, column_cell, overrides
from .small import ROOT, SMALL, _DRIVER

SEED = 2718281828459


def old_step(ref):
    """The reference's step before it ran phases, kept here only."""
    st = ref.state
    tr = {n: st[f"tracers.{n}"] for n in TRACERS}
    vel = velocity.solve(
        ref.vgeo, {k: st[f"velocity.{k}"] for k in VELOCITY},
        tr["iceAreaCategory"], tr["iceVolumeCategory"],
        tr["snowVolumeCategory"], ref.wind, ref.dt, ref.n_sub)
    tr = transport.remap(ref.tgeo, tr, vel["u_velocity"],
                         vel["v_velocity"], ref.dt)
    out = {f"velocity.{k}": v for k, v in vel.items()}
    out.update({f"tracers.{k}": v for k, v in tr.items()})
    out["time"] = st["time"] + ref.dt
    return out


def test_dynamics_phase_is_the_old_step_bitwise():
    c = Cell(CELL)
    c.apply(SMALL)
    assert model.phase_names(c.config) == ["dynamics"]
    ref = reference_side(c.config, c.traffic, SEED, "cpu")
    for _ in range(2):
        want = old_step(ref)
        ref.step()
        assert set(ref.state) == set(want)
        for k, v in want.items():
            assert torch.equal(ref.state[k], v), k


def test_column_on_needs_a_phase_that_steps_it():
    conf = column_cell().config
    with pytest.raises(NotImplementedError, match="column.use_column"):
        model.check_config(conf)
    with pytest.raises(NotImplementedError, match="no phase .absent."):
        model.check_config(dict(conf, reference=["dynamics", "absent"]))
    e3sm = column_cell("column_e3sm").config
    with pytest.raises(NotImplementedError, match="pond_scheme"):
        model.check_config(dict(e3sm, reference=["dynamics"]))


def test_no_phase_ends_the_run_before_the_program_is_built():
    """Through `cli.main`: "no result" naming what is missing, and the
    program never imported."""
    code = _DRIVER.replace(
        "sys.exit(main(", "rc = (main(") + (
        "print(rc, any(m.split('.')[0] == 'seaice_tpu_torch' "
        "for m in sys.modules))\n")
    entry = {"name": "qu60_column.winter", "config": "qu60_dycore",
             "traffic": "winter_caps", "chips": 1, "why": "a test"}
    o = overrides("column_bl99")
    o["workload"] = {"limits": Cell(CELL).limits["limits"]}
    spec = {"argv": ["--workload", entry["name"], "--seed", "5",
                     "--seconds", "51", "--trace", "0"],
            "overrides": o, "fault": None, "entry": entry}
    r = subprocess.run([sys.executable, "-c", code.format(root=ROOT),
                        json.dumps(spec)], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.stdout.strip().splitlines()[-1] == "5 False", r.stderr[-2000:]
    assert "no result: the reference has no phase that steps " \
        "column.use_column_package = True" in r.stderr


PROBE_PHASE = '''"""A phase that steps the column by leaving it as it is, and says
what forcing it was given."""
import sys

CLAIMS = ("column",)


def check_config(conf):
    if conf["column"].get("ktherm", 1) != 1:
        raise NotImplementedError("column.ktherm")


def build(ref, conf):
    ref.probe_steps = 0


def step(ref, state):
    f = ref.column_forcing(state)
    ref.probe_steps += 1
    print(f"probe phase: step {ref.probe_steps}, day {f['day_of_year']}, "
          f"{len(f)} forcing fields", file=sys.stderr)
    return state
'''


def test_a_new_phase_is_found_by_its_files_name(tmp_path):
    """In a copy of the benchmark, a column cell comes in as new files
    (configuration, traffic, limits, a reference phase) and a workload
    entry, and a run of the harness steps the program's column and the
    new phase."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    src = os.path.join(ROOT, "benchmark")
    bench = tmp_path / "benchmark"
    shutil.copytree(src, bench, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    col = column_cell(small=False)
    conf = dict(col.config, name="qu60_column_probe",
                reference=["column_probe", "dynamics"])
    (bench / "configs" / "qu60_column_probe.json").write_text(
        json.dumps(conf))
    (bench / "traffic" / "winter_column.json").write_text(
        json.dumps(col.traffic))
    name = "qu60_column_probe.winter_column"
    (bench / "workloads" / (name + ".json")).write_text(
        json.dumps(col.limits))
    (bench / "reference" / "column_probe.py").write_text(PROBE_PHASE)
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": name, "config": "qu60_column_probe",
                           "traffic": "winter_column", "chips": 1,
                           "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())

    spec = {"argv": ["--workload", name, "--seed", "17", "--seconds", "0.5",
                     "--trace", "0"], "overrides": SMALL, "fault": None,
            "entry": None}
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c",
                        _DRIVER.format(root=str(tmp_path)),
                        json.dumps(spec)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "probe phase: step 1, day 1, 21 forcing fields" in r.stderr


def test_a_phase_adds_the_fields_of_its_tracers(monkeypatch):
    """A phase's `init_state` adds fields to the reference's initial
    state, which `load` and `step` then carry."""
    found = model.phase

    def add_age(ref, state):
        return dict(state, **{"tracers.iceAge": torch.zeros_like(
            state["tracers.iceAreaCategory"])})

    age = types.SimpleNamespace(
        CLAIMS=("column",), check_config=lambda conf: None,
        build=lambda ref, conf: None, init_state=add_age,
        step=lambda ref, state: dict(state, **{
            "tracers.iceAge": state["tracers.iceAge"] + ref.dt}))
    monkeypatch.setattr(model, "phase", lambda name: age if name == "age"
                        else found(name))
    c = column_cell()
    conf = dict(c.config, reference=["age", "dynamics"])
    ref = reference_side(conf, c.traffic, SEED, "cpu")
    assert "tracers.iceAge" in ref.state
    fields = {k: v.numpy() for k, v in ref.state.items()}
    ref.load(fields)
    ref.step()
    assert float(ref.state["tracers.iceAge"].max()) == ref.dt
