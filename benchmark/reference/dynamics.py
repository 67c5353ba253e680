"""The reference's dynamical-core phase: the EVP velocity solve on
Wachspress functions (`velocity.py`), then the incremental remapping of
the standard tracer tree under the new velocities (`transport.py`), as
MPAS-Seaice steps its dynamics.  A phase of `model.Reference`."""

from __future__ import annotations

from . import transport, velocity

CLAIMS = ("velocity", "advection")
VELOCITY = ("u_velocity", "v_velocity", "stress11", "stress22", "stress12",
            "solve_velocity_prev")
TRACERS = tuple(n for n, _, _ in transport.TREE)
# the column options that add a tracer to the program's tree, at the
# values (the program's defaults) that add none: with them the column's
# tree is the standard one
TREE_NEUTRAL = {"use_ice_age": False, "use_first_year_ice": False,
                "use_level_ice": False, "pond_scheme": "none",
                "use_snow_tracers": False, "n_aerosols": 0,
                "use_brine_height": False, "use_biogeochemistry": False,
                "use_skeletal_biochemistry": False,
                "solve_zsalinity": False}


def check_config(conf: dict):
    """The options this phase implements; any other raises."""
    want = {("velocity", "strain_scheme"): "VARIATIONAL",
            ("velocity", "variational_basis"): "WACHSPRESS",
            ("velocity", "include_metric_terms"): True,
            ("velocity", "rotate_cartesian_grid"): True,
            ("advection", "advection_type"): "INCREMENTAL_REMAP"}
    tree = conf.get("tracer_tree")
    if tree == "column":
        col = conf.get("column", {})
        for k, v in TREE_NEUTRAL.items():
            if col.get(k, v) != v:
                raise NotImplementedError(
                    f"the dynamics phase transports the standard tracer "
                    f"tree, not the column's with column.{k} = {col[k]!r}")
    elif tree != "standard":
        raise NotImplementedError(
            f"the reference implements tracer_tree = 'standard' or "
            f"'column', not {tree!r}")
    for keys, value in want.items():
        got = conf
        for k in keys:
            got = got.get(k) if isinstance(got, dict) else None
        if got != value:
            raise NotImplementedError(
                f"the reference implements {'.'.join(keys)} = {value!r}, "
                f"not {got!r}")


def build(ref, conf: dict):
    """The velocity solve's and the remap's geometry on the reference's
    mesh."""
    ref.n_sub = int(conf["velocity"]["elastic_subcycle_number"])
    ref.vgeo = velocity.VelocityGeometry(ref.mesh, ref.dtype, ref.device)
    ref.tgeo = transport.RemapGeometry(ref.mesh, ref.dtype, ref.device)


def step(ref, state: dict) -> dict:
    """The velocity solve under the reference's wind, then the remap."""
    tr = {n: state[f"tracers.{n}"] for n in TRACERS}
    vel = velocity.solve(
        ref.vgeo, {k: state[f"velocity.{k}"] for k in VELOCITY},
        tr["iceAreaCategory"], tr["iceVolumeCategory"],
        tr["snowVolumeCategory"], ref.wind, ref.dt, ref.n_sub)
    tr = transport.remap(ref.tgeo, tr, vel["u_velocity"],
                         vel["v_velocity"], ref.dt)
    out = dict(state)
    out.update({f"velocity.{k}": v for k, v in vel.items()})
    out.update({f"tracers.{k}": v for k, v in tr.items()})
    return out
