"""Faults planted in the program's column, for the calibration of a column
cell's limits (`calibrate_column.py`) and the benchmark's tests: each a
context manager inside which the program's step is broken in one place.

  * `picard_cut_short`: the mushy Picard heat solve stops after 2
    iterations, converged or not;
  * `shortwave_zeroed`: the delta-Eddington shortwave returns no absorbed
    or transmitted shortwave (the albedos are kept)."""

from __future__ import annotations

import contextlib
import importlib

PROGRAM = "seaice_tpu_torch"


def _mod(name):
    return importlib.import_module(f"{PROGRAM}.{name}")


@contextlib.contextmanager
def _patched(module, name, wrap):
    mod = _mod(module)
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def picard_cut_short(iterations: int = 2):
    def wrap(orig):
        def cut(one_iteration, carry, converged_index, nitermax=None):
            return orig(one_iteration, carry, converged_index,
                        nitermax=iterations)
        return cut
    return _patched("column.mushy_solver", "run_until_converged", wrap)


def shortwave_zeroed():
    def wrap(orig):
        def zeroed(*a, **k):
            r = orig(*a, **k)
            return r._replace(**{f: getattr(r, f) * 0.0 for f in (
                "fswsfc", "fswint", "fswthru", "Iswabs", "Sswabs")})
        return zeroed
    return _patched("column.dedd", "shortwave_dedd", wrap)


COLUMN_FAULTS = {"picard_cut_short": picard_cut_short,
                 "shortwave_zeroed": shortwave_zeroed}
