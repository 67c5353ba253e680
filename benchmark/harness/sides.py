"""The two sides of a cell, built from the same configuration file, traffic
file and seed:
  * `Side`: the program (`seaice_tpu_torch`) as a user drives it:
    `SeaIceModel(...).make_step()` under the analytic wind, one call a
    step, the state checked on the device after it; with the column on,
    the step is also given the column's atmosphere, ocean and sun;
  * `reference_side`: the benchmark's plain reference
    (`benchmark/reference`), given the same seeded inputs on its own mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import importlib
import time

import numpy as np
import torch

from . import inputs

PROGRAM = "seaice_tpu_torch"


def _mod(name: str):
    return importlib.import_module(f"{PROGRAM}.{name}")


def make_config(conf: dict):
    """The program's `Config` from a configuration file's `run`,
    `velocity`, `advection` and `column` groups (enum options by name)."""
    C = _mod("config")

    def group(cls, values):
        default = cls()
        kw = {}
        for k, v in values.items():
            cur = getattr(default, k)
            kw[k] = type(cur)[v] if isinstance(cur, enum.Enum) else v
        return cls(**kw)

    return C.Config(
        run=group(C.RunConfig, conf.get("run", {})),
        velocity=group(C.VelocitySolverConfig, conf.get("velocity", {})),
        advection=group(C.AdvectionConfig, conf.get("advection", {})),
        column=group(C.ColumnConfig, conf.get("column", {})))


def column_on(conf: dict) -> bool:
    """Whether the configuration runs the column (the program's default
    where the file does not say)."""
    return conf.get("column", {}).get("use_column_package", True)


def check_inputs(conf: dict, traffic: dict):
    """A configuration whose column is on needs the traffic's column
    forcing."""
    if column_on(conf) and "column_forcing" not in traffic:
        raise ValueError("the column is on and the traffic has no "
                         "\"column_forcing\" group")


def flatten_state(state) -> dict:
    """{"velocity.<field>", "tracers.<name>", "time": tensor}."""
    out = {f"velocity.{f.name}": getattr(state.velocity, f.name)
           for f in dataclasses.fields(state.velocity)}
    out.update({f"tracers.{k}": v for k, v in state.tracers.items()})
    out["time"] = state.time
    return out


class Side:
    """The program's model with its state and step.  With the column on,
    `step` gives the model the column forcing: the fields that do not
    follow the sun once, and the sun of the step from a day's table on
    the device, indexed by the steps taken (a host count: no sync)."""

    def __init__(self, conf, traffic, seed, device, dtype):
        if conf["path"] != "model_step":
            raise ValueError(f"unknown path {conf['path']!r}")
        check_inputs(conf, traffic)
        self.conf = conf
        self.traffic = traffic
        self.device = torch.device(device)
        self.dtype = dtype
        self.timings = {}
        t0 = time.perf_counter()
        mc = conf["mesh"]
        if mc["kind"] != "icosahedral":
            raise ValueError(f"unknown mesh kind {mc['kind']!r}")
        self.mesh = _mod("mesh").icosahedral_mesh(mc["subdivisions"])
        if mc.get("panel", False):
            self.mesh, _ = _mod("mesh.panels").panel_reorder(
                self.mesh, mc["subdivisions"])
        self.cfg = make_config(conf)
        tree = None
        if conf.get("tracer_tree") == "standard":
            tree = _mod("transport.tracers").standard_tracer_tree(
                n_ice_layers=self.cfg.run.n_ice_layers,
                n_snow_layers=self.cfg.run.n_snow_layers)
        elif conf.get("tracer_tree") not in (None, "column"):
            # "column": the model's own tree from the column options
            raise ValueError(f"unknown tracer tree {conf['tracer_tree']!r}")
        self.model = _mod("model").SeaIceModel(
            self.mesh, self.cfg, dtype=dtype, device=self.device,
            tracer_tree=tree)
        self.timings["layout_s"] = time.perf_counter() - t0
        self._step_fn = self.model.make_step()
        self.seed_inputs(seed)

    def seed_inputs(self, seed):
        """The seeded initial state, the analytic wind and, with the
        column on, the column forcing."""
        run = self.cfg.run
        caps = inputs.caps_state(self.mesh, run.n_categories,
                                 run.n_ice_layers, run.n_snow_layers,
                                 self.traffic, seed)
        state = self.model.init_state(caps["iceAreaCategory"],
                                      caps["iceVolumeCategory"],
                                      caps["snowVolumeCategory"])
        tr = dict(state.tracers)
        for k, v in caps.items():
            tr[k] = self._t(v)
        start = inputs.start_seconds(self.traffic, run.dt, seed)
        self.state = state.replace(tracers=tr, time=state.time + start)
        uw, vw = inputs.analytic_wind(self.mesh, self.traffic, seed)
        z = np.zeros(self.mesh.n_cells)
        self.forcing = _mod("dynamics.evp").DynamicsForcing(
            u_air_velocity=self._t(uw), v_air_velocity=self._t(vw),
            air_density=self._t(np.full(self.mesh.n_cells, 1.3)),
            u_ocean_velocity=self._t(z), v_ocean_velocity=self._t(z),
            sea_surface_tilt_u=self._t(z), sea_surface_tilt_v=self._t(z),
            land_ice_mask=self._t(z))
        self.column = None
        self.warnings = {}
        self.n_steps = 0
        if self.model.column is not None:
            self._seed_column(seed, start)
        self.initial = flatten_state(self.state)

    def _seed_column(self, seed, start):
        """The column forcing: one AtmosForcing for each step of a day,
        sharing every field but the sun's, and the ocean."""
        drv = _mod("column.driver")
        ci = inputs.ColumnInputs(self.mesh, self.traffic, seed,
                                 self.cfg.run.dt, start)
        f = {k: self._t(v) for k, v in ci.fields.items()
             if k not in inputs.SUN}
        f["u_air"] = self.forcing.u_air_velocity
        f["v_air"] = self.forcing.v_air_velocity
        table = {k: v.to(self.dtype) for k, v in
                 ci.sun_table(self.device).items()}
        atmos = [drv.AtmosForcing(**{k: f[k] if k in f else table[k][i]
                                     for k in inputs.ATMOS})
                 for i in range(ci.per_day)]
        self.column = {
            "inputs": ci, "atmos": atmos, "coszen": table["coszen"],
            "ocean": drv.OceanForcing(**{k: f[k] for k in inputs.OCEAN}),
            "lat": self._t(ci.lat)}

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=self.device, dtype=self.dtype)

    def step(self):
        """One step; the device's synchronise is the flag fetch of
        `check`."""
        col = self.column
        if col is None:
            self.state, _ = self._step_fn(self.model.tensors, self.state,
                                          self.forcing)
        else:
            i = self.n_steps % col["inputs"].per_day
            self.state, diags = self._step_fn(
                self.model.tensors, self.state, self.forcing,
                atmos=col["atmos"][i], ocean=col["ocean"],
                coszen=col["coszen"][i],
                day_of_year=col["inputs"].day_of_year(self.n_steps),
                lat=col["lat"])
            self.warnings = diags["column_fluxes"].warnings or {}
        self.n_steps += 1

    def check(self) -> dict:
        """The harness's state check of the current state, fetched to the
        host in one copy: finite, |u| < 3 m/s, aice <= 1 + 1e-6; with the
        column on, no cell flagged by the last step's column warnings
        (`column_<warning>`, the runner's abort gate)."""
        st = self.state
        a = st.tracers["iceAreaCategory"]
        u, v = st.velocity.u_velocity, st.velocity.v_velocity
        speed = torch.sqrt(u * u + v * v)
        names = ["finite_ice", "finite_velocity", "speed_below_3",
                 "aice_at_most_1"]
        flags = [
            torch.isfinite(a).all() & torch.isfinite(
                st.tracers["iceVolumeCategory"]).all(),
            torch.isfinite(speed).all(),
            (speed < 3.0).all(),
            (a.sum(-1) <= 1.0 + 1e-6).all(),
        ]
        for k, mask in self.warnings.items():
            names.append(f"column_{k}")
            flags.append(~mask.any())
        got = torch.stack(flags).cpu().numpy()
        return dict(zip(names, (bool(f) for f in got)))

    def snapshot(self) -> dict:
        """A copy of the state on the device."""
        return {k: t.detach().clone() for k, t in
                flatten_state(self.state).items()}

    def load(self, fields: dict):
        """Set the state from numpy arrays keyed as `flatten_state`'s, in
        this side's mesh order."""
        st = self.state
        vel = st.velocity.replace(**{
            f.name: self._t(fields[f"velocity.{f.name}"])
            for f in dataclasses.fields(st.velocity)})
        tr = {k: self._t(fields[f"tracers.{k}"]) for k in st.tracers}
        self.state = st.replace(velocity=vel, tracers=tr,
                                time=self._t(fields["time"]))
        if self.column is not None:
            # the sun's table follows the loaded clock
            self.n_steps = self.column["inputs"].step_of(
                float(fields["time"]))


@contextlib.contextmanager
def velocity_loop_cut_short(share: float = 0.5):
    """Inside, the program's whole-loop panel kernel (K3) runs `share` of
    its elastic subcycles at the configured elastic step: a velocity solve
    whose loop ends early, a fault of the velocity solve alone (for the
    benchmark's calibration and tests)."""
    evp = _mod("dynamics.evp")
    orig = evp.evp_panel_loop

    def cut(*a, n_subcycles, **k):
        return orig(*a, n_subcycles=max(1, int(n_subcycles * share)), **k)

    evp.evp_panel_loop = cut
    try:
        yield
    finally:
        evp.evp_panel_loop = orig


def reference_side(conf, traffic, seed, device, dtype=torch.float64):
    """The reference built for the configuration, with the seed's
    inputs."""
    from ..reference.model import Reference
    ref = Reference(conf, device, dtype)
    seed_reference(ref, conf, traffic, seed)
    return ref


def seed_reference(ref, conf, traffic, seed):
    """The seed's inputs on the reference's mesh: the caps, the wind and,
    with the column on, the column forcing (`inputs.ColumnInputs`)."""
    run = conf["run"]
    start = inputs.start_seconds(traffic, run["dt"], seed)
    column = None
    if column_on(conf):
        column = inputs.ColumnInputs(ref.mesh, traffic, seed, run["dt"],
                                     start)
    ref.set_inputs(
        inputs.caps_state(ref.mesh, run["n_categories"], run["n_ice_layers"],
                          run["n_snow_layers"], traffic, seed),
        inputs.analytic_wind(ref.mesh, traffic, seed), start, column)
