"""The column examples of the benchmark's tests: overrides over the
dynamical-core cell's configuration and traffic that turn the column on
with the traffic's column forcing (`column_bl99.json`: the port's default
column, BL99 thermodynamics; `column_e3sm.json`: mushy thermodynamics,
delta-Eddington shortwave, level-ice ponds and Rothrock strength, the
column as E3SM runs it)."""

import json
import os

from benchmark.harness.manifest import Cell, merge

from .small import SMALL

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "qu60_dycore.winter_caps"


def overrides(name: str, small: bool = True) -> dict:
    """The overrides of `<name>.json`, at the tests' small size."""
    with open(os.path.join(HERE, name + ".json")) as f:
        o = json.load(f)
    if small:
        o = {k: merge(o.get(k, {}), SMALL.get(k, {}))
             for k in set(o) | set(SMALL)}
    return o


def column_cell(name: str = "column_bl99", small: bool = True) -> Cell:
    c = Cell(CELL)
    c.apply(overrides(name, small))
    return c
