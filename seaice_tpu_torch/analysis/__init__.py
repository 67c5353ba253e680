"""Analysis members: the pluggable diagnostics framework (the port of the
JAX package's `analysis/`; reference `src/analysis_members/`: driver
`mpas_seaice_analysis_driver.F:150-168,410-560` + 19 members)."""

from .driver import AnalysisDriver, AnalysisMember
from .members import (ConservationCheckMember, HighFrequencyOutputMember,
                      IcePresenceMember, MaximumIcePresenceMember,
                      RegionalStatisticsMember, TemperaturesMember,
                      TimeSeriesStatsMember, AreaVariablesMember,
                      LoadBalanceMember, PointwiseStatsMember,
                      default_members)
