"""Column physics: the grid-independent per-cell physics package.

Port of the JAX package's `column/` (the CICE column package, API facade
`ice_colpkg.F90:19-68`): every routine works on dense tensors over the
leading batch dims [nCells, nCategories] with the vertical layer axis
last.  The modules of the main path: thermodynamics (BL99 `bl99`,
mushy `mushy` + `mushy_solver`, `vertical`, `itd_thermo`), radiation
(`shortwave`, `dedd`, `orbital`), level-ice ponds (`ponds`), the
atmosphere boundary layer (`atmo`), the ITD, strength and ridging
(`itd`, `ridging`), and the phase drivers (`driver`).
"""

from . import constants  # noqa: F401
from .thermo_shared import (salinity_profile, melting_temperature,  # noqa
                            ice_enthalpy_from_temperature,
                            ice_temperature_from_enthalpy,
                            snow_enthalpy_from_temperature,
                            snow_temperature_from_enthalpy,
                            sea_freezing_temperature,
                            init_thermo_tracers)
from .driver import (AtmosForcing, OceanForcing, ColumnFluxes,  # noqa
                     ColumnPhysics, slab_ocean_frzmlt)
from .orbital import compute_coszen, solar_declination  # noqa: F401
