"""The reference's step: the phases that the configuration file names
under "reference", in order (["dynamics"] where it names none), each the
module `benchmark/reference/<phase>.py`, found by its file's name.  It imports
nothing of the program: it is built from the benchmark's own mesh
(`sphere.py`), the cell's configuration file and the seeded inputs that
the program is given.

A phase module has
  * `check_config(conf)`: raises NotImplementedError naming an option
    it does not implement;
  * `build(ref, conf)`: its geometry and constants, kept on `ref`;
  * `step(ref, state) -> state`, on the flat state dict;
  * `CLAIMS`: the option groups whose physics it steps ("velocity",
    "advection", "column");
  * optionally `init_state(ref, state) -> state`: the initial fields its
    physics adds to the caps' tracers and the velocities (a column
    whose tree holds more tracers than the standard one).
A later cell adds a phase by adding its file; no file here needs an
edit.

The state is a flat dict of tensors keyed as the harness keys the
program's: "velocity.<field>" (u, v at vertices; the stresses at cell
corners; the last step's velocity mask), "tracers.<name>" and "time".
The clock moves on by dt after the last phase."""

from __future__ import annotations

import importlib
import os
import time

import torch

from . import sphere
from .dynamics import TRACERS

PHASE_DIR = os.path.dirname(os.path.abspath(__file__))


def phase_names(conf: dict) -> list:
    return list(conf.get("reference", ["dynamics"]))


def phase(name: str):
    """The module `benchmark/reference/<name>.py`."""
    if not (name.isidentifier() and
            os.path.exists(os.path.join(PHASE_DIR, name + ".py"))):
        raise NotImplementedError(f"the reference has no phase {name!r}")
    return importlib.import_module(f"{__package__}.{name}")


def check_config(conf: dict) -> list:
    """The configuration's phases, once each has checked it; raises
    NotImplementedError for an option that the reference or a phase does
    not implement, or an option group that no phase steps (the column
    where it is on).  Builds nothing."""
    want = {("mesh", "kind"): "icosahedral", ("path",): "model_step"}
    for keys, value in want.items():
        got = conf
        for k in keys:
            got = got.get(k) if isinstance(got, dict) else None
        if got != value:
            raise NotImplementedError(
                f"the reference implements {'.'.join(keys)} = {value!r}, "
                f"not {got!r}")
    names = phase_names(conf)
    mods = [phase(n) for n in names]
    for m in mods:
        m.check_config(conf)
    groups = {"velocity", "advection"}
    if conf.get("column", {}).get("use_column_package", True):
        groups.add("column")
    missing = groups - {g for m in mods for g in m.CLAIMS}
    if missing:
        what = ("column.use_column_package = True" if "column" in missing
                else " and ".join(sorted(missing)))
        raise NotImplementedError(
            f"the reference has no phase that steps {what} (its phases: "
            f"{names})")
    return mods


class Reference:
    """The reference built for a configuration, in `dtype` on `device`."""

    def __init__(self, conf: dict, device, dtype=torch.float64, mesh=None):
        self.phases = check_config(conf)
        t0 = time.perf_counter()
        self.device = torch.device(device)
        self.dtype = dtype
        self.dt = float(conf["run"]["dt"])
        self.mesh = mesh or sphere.build(conf["mesh"]["subdivisions"])
        for p in self.phases:
            p.build(self, conf)
        self.state = None
        self.wind = None
        self.column = None
        self.build_s = time.perf_counter() - t0

    def _t(self, a):
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

    def set_inputs(self, caps: dict, wind, start_seconds: float,
                   column=None):
        """The initial state from the seeded caps (numpy, this mesh's
        order) and the wind (u, v) [nc] in the rotated grid.  column: the
        column forcing on this mesh, for the phases that step the column
        (`column_forcing`)."""
        nc, me = self.mesh.vertices_on_cell.shape
        nv = self.mesh.n_vertices
        z = torch.zeros
        st = {f"tracers.{n}": self._t(caps[n]) for n in TRACERS}
        st.update({f"velocity.{k}": z(nv, dtype=self.dtype,
                                      device=self.device)
                   for k in ("u_velocity", "v_velocity",
                             "solve_velocity_prev")})
        st.update({f"velocity.{k}": z((nc, me), dtype=self.dtype,
                                      device=self.device)
                   for k in ("stress11", "stress22", "stress12")})
        st["time"] = self._t(start_seconds)
        uw, vw = (self._t(a) for a in wind)
        self.wind = (uw, vw, torch.full_like(uw, 1.3))
        self.column = column
        for p in self.phases:
            if hasattr(p, "init_state"):
                st = p.init_state(self, st)
        self.state = st

    def column_forcing(self, state: dict) -> dict:
        """The column forcing of the step that starts from `state`, as
        tensors of this reference: every field of the program's
        AtmosForcing and OceanForcing, "coszen", "lat" and "day_of_year"
        (a number)."""
        n = self.column.step_of(float(state["time"]))
        out = {k: self._t(v) for k, v in self.column.at(n).items()}
        out["lat"] = self._t(self.column.lat)
        out["day_of_year"] = self.column.day_of_year(n)
        return out

    def load(self, fields: dict):
        """Set the state from arrays keyed as the state is."""
        self.state = {k: self._t(fields[k]) for k in self.state}

    def step(self):
        st = self.state
        for p in self.phases:
            st = p.step(self, st)
        self.state = dict(st, time=self.state["time"] + self.dt)
