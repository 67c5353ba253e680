"""The reference's ridging after the transport: the mechanical
redistribution of the thickness distribution under the ridging rates of
the step's velocities (`column_dynamics.ridge_rates`), with exponential
participation and redistribution (Lipscomb et al. 2007; Icepack
`ice_mechred.F90`), then the removal of negligible categories
(`column_itd.ridge`, `column_itd.cleanup`).  A phase of
`model.Reference`, after `column_dynamics`."""

from __future__ import annotations

from . import column_itd
from .column import AREA_TRACERS, ICE_TRACERS, SNOW_TRACERS, check_column

CLAIMS = ("column",)


def check_config(conf: dict):
    check_column(conf)


def build(ref, conf: dict):
    pass


def step(ref, state: dict) -> dict:
    conv, shear = ref.ridge_rates
    tr = {k[8:]: v for k, v in state.items() if k.startswith("tracers.")}
    groups = [{k: tr[k] for k in names}
              for names in (AREA_TRACERS, ICE_TRACERS, SNOW_TRACERS)]
    res = column_itd.ridge(ref.dt, ref.hin_max, conv.clamp(min=0.0),
                           shear.clamp(min=0.0), tr["iceAreaCategory"],
                           tr["iceVolumeCategory"], tr["snowVolumeCategory"],
                           *groups)
    a, v, vs, at, it, st = column_itd.cleanup(*res)
    out = dict(state)
    out.update({"tracers.iceAreaCategory": a, "tracers.iceVolumeCategory": v,
                "tracers.snowVolumeCategory": vs})
    for d in (at, it, st):
        out.update({f"tracers.{k}": x for k, x in d.items()})
    return out
