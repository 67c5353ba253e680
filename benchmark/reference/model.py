"""The reference's dynamical-core step: the velocity solve, then the
transport of every tracer under the new velocities (MPAS-Seaice with
`config_use_column_package = false`).  It imports nothing of the program:
it is built from the benchmark's own mesh (`sphere.py`), the cell's
configuration file and the seeded inputs that the program is given.

Its state is a flat dict of tensors keyed as the harness keys the
program's: "velocity.<field>" (u, v at vertices; the stresses at cell
corners; the last step's velocity mask), "tracers.<name>" and "time"."""

from __future__ import annotations

import time

import torch

from . import sphere, transport, velocity

VELOCITY = ("u_velocity", "v_velocity", "stress11", "stress22", "stress12",
            "solve_velocity_prev")
TRACERS = tuple(n for n, _, _ in transport.TREE)


def check_config(conf: dict):
    """The options this reference implements; any other raises."""
    want = {("mesh", "kind"): "icosahedral", ("tracer_tree",): "standard",
            ("path",): "model_step",
            ("velocity", "strain_scheme"): "VARIATIONAL",
            ("velocity", "variational_basis"): "WACHSPRESS",
            ("velocity", "include_metric_terms"): True,
            ("velocity", "rotate_cartesian_grid"): True,
            ("advection", "advection_type"): "INCREMENTAL_REMAP",
            ("column", "use_column_package"): False}
    for keys, value in want.items():
        got = conf
        for k in keys:
            got = got.get(k) if isinstance(got, dict) else None
        if got != value:
            raise NotImplementedError(
                f"the reference implements {'.'.join(keys)} = {value!r}, "
                f"not {got!r}")


class Reference:
    """The reference built for a configuration, in `dtype` on `device`."""

    def __init__(self, conf: dict, device, dtype=torch.float64, mesh=None):
        check_config(conf)
        t0 = time.perf_counter()
        self.device = torch.device(device)
        self.dtype = dtype
        run = conf["run"]
        self.dt = float(run["dt"])
        self.n_sub = int(conf["velocity"]["elastic_subcycle_number"])
        self.mesh = mesh or sphere.build(conf["mesh"]["subdivisions"])
        self.vgeo = velocity.VelocityGeometry(self.mesh, dtype, self.device)
        self.tgeo = transport.RemapGeometry(self.mesh, dtype, self.device)
        self.state = None
        self.wind = None
        self.build_s = time.perf_counter() - t0

    def _t(self, a):
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

    def set_inputs(self, caps: dict, wind, start_seconds: float):
        """The initial state from the seeded caps (numpy, this mesh's
        order) and the wind (u, v) [nc] in the rotated grid."""
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
        self.state = st
        uw, vw = (self._t(a) for a in wind)
        self.wind = (uw, vw, torch.full_like(uw, 1.3))

    def load(self, fields: dict):
        """Set the state from arrays keyed as the state is."""
        self.state = {k: self._t(fields[k]) for k in self.state}

    def step(self):
        st = self.state
        tr = {n: st[f"tracers.{n}"] for n in TRACERS}
        vel = velocity.solve(
            self.vgeo, {k: st[f"velocity.{k}"] for k in VELOCITY},
            tr["iceAreaCategory"], tr["iceVolumeCategory"],
            tr["snowVolumeCategory"], self.wind, self.dt, self.n_sub)
        tr = transport.remap(self.tgeo, tr, vel["u_velocity"],
                             vel["v_velocity"], self.dt)
        out = {f"velocity.{k}": v for k, v in vel.items()}
        out.update({f"tracers.{k}": v for k, v in tr.items()})
        out["time"] = st["time"] + self.dt
        self.state = out
