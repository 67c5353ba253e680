"""Standalone forcing (reference `mpas_seaice_forcing.F` and the
MPAS_forcing framework it uses): the clock and the CORE / NCAR series."""

from .clock import Alarm, ModelClock  # noqa: F401
from .core import (ForcingSeries, CoreAtmosForcing,  # noqa: F401
                   NcarOceanForcing, DataIcebergForcing,
                   derive_atmos_fields, shortwave_split,
                   longwave_rosati_miyakoda, longwave_parkinson_washington,
                   shortwave_down, limit_specific_humidity,
                   split_precipitation)
