"""The reference's column phase after the dynamics (MPAS-Seaice
seaice_column_postdynamics_time_integration): with no snow tracers the
snow physics does not run, and what is left, the coupler's aggregates and
the next step's radiation (folded into `column_thermo`), changes no state.
A phase of `model.Reference`, last in its step."""

from __future__ import annotations

from .column import check_column

CLAIMS = ("column",)


def check_config(conf: dict):
    check_column(conf)


def build(ref, conf: dict):
    pass


def step(ref, state: dict) -> dict:
    return state
