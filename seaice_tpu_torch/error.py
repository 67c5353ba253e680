"""Critical-error handling: cooperative abort with full state dump.

The port of the JAX package's `error.py`, the reference's
`mpas_seaice_error.F` (seaice_check_critical_error :80: max-reduce an
abort flag across ranks, write the abort stream, halt) and the Registry
abort/abort_block crash-dump streams (Registry.xml:2163-2248): the abort
decision comes from the flags of `diagnostics.check_state`, fetched to
the host in ONE device-to-host copy per check; on failure the full
State plus the failing-check list is dumped bitwise before raising.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .diagnostics import check_state
from .model import State


class SeaIceAbort(RuntimeError):
    """Raised after a failed state check; the dump path is attached."""

    def __init__(self, message: str, dump_path: Optional[str]):
        super().__init__(message)
        self.dump_path = dump_path


def fetch_flags(checks: Dict[str, Any]) -> Dict[str, bool]:
    """{name: flag tensor} -> {name: bool}, every flag reduced with
    all() on the device and copied to the host together."""
    flags = torch.stack([torch.as_tensor(v).all() for v in checks.values()])
    return dict(zip(checks, flags.cpu().tolist()))


def write_abort_dump(run_dir: str, state: State, timestamp: str,
                     failed_checks) -> str:
    """Write the crash-dump 'abort stream' (full prognostic state +
    metadata), mirroring config_full_abort_write (Registry :356-359)."""
    from .io.checkpoint import save_checkpoint
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"abort.{timestamp}.npz")
    save_checkpoint(path, state, {
        "failed_checks": np.array([str(f) for f in failed_checks])})
    return path


def _tracer_arrays(state) -> Dict[str, np.ndarray]:
    """Every tracer as numpy [nCells, ...]; a partitioned state (a list
    of blocks) is stacked and its block axis flattened, so that a cell
    index addresses the (block * localCell) dimension."""
    states: List[State] = state if isinstance(state, list) else [state]
    return {name: np.concatenate([st.tracers[name].detach().cpu().numpy()
                                  for st in states])
            for name in states[0].tracers}


def write_cell_failure_dump(run_dir: str, state: State, cell_idx,
                            reason: str, timestamp: str,
                            max_cells: int = 32) -> str:
    """Per-cell failure dump: the FULL column state of the failing
    cells (every tracer sliced at those cells) plus the warning
    reason, the analog of the reference's column warning buffer and
    per-cell state print on abort (ice_warnings.F90;
    mpas_seaice_column.F:1872-1939 prints lat/lon and all category
    tracers of the failing cell)."""
    os.makedirs(run_dir, exist_ok=True)
    cell_idx = np.asarray(cell_idx)[:max_cells]
    fields = {"cell_index": cell_idx, "reason": np.array(reason)}
    for name, a in _tracer_arrays(state).items():
        fields["tracer_" + name] = a[cell_idx]
    path = os.path.join(run_dir, f"cell_failure.{timestamp}.npz")
    np.savez(path, **fields)
    return path


def raise_on_failed_checks(checks: Dict[str, Any], state: State,
                           timestamp: str,
                           run_dir: Optional[str] = None,
                           cell_masks: Optional[Dict[str, Any]] = None,
                           write_dump=None) -> None:
    """Host abort gate for checks already computed on the device (by
    the runner's step, the per-step seaice_check_state analog).

    cell_masks: optional {check_name: per-cell bool 'problem' mask}
    for checks with per-cell attribution (column warnings); failing
    cells get a dedicated full-column dump.  The masks are fetched
    only on failure.  write_dump(run_dir, state, timestamp, failed)
    -> path writes the abort dump (default `write_abort_dump`)."""
    flags = fetch_flags(checks)
    if flags["ok"]:
        return
    failed = [k for k, v in flags.items() if k != "ok" and not v]
    dump = None
    cell_dumps = []
    if run_dir is not None:
        dump = (write_dump or write_abort_dump)(run_dir, state, timestamp,
                                                failed)
        for name in failed:
            if not cell_masks or name not in cell_masks:
                continue
            mask = torch.as_tensor(cell_masks[name]).cpu().numpy()
            while mask.ndim > 1:       # [*, nCat, ...] -> per cell
                mask = mask.any(-1)
            idx = np.nonzero(mask.reshape(-1))[0]
            if len(idx):
                cell_dumps.append(write_cell_failure_dump(
                    run_dir, state, idx, name, timestamp))
    raise SeaIceAbort(
        f"critical state-check failure at {timestamp}: {failed}"
        + (f" (state dumped to {dump})" if dump else "")
        + (f" (failing cells dumped to {cell_dumps})"
           if cell_dumps else ""), dump)


def check_critical_error(state: State, timestamp: str,
                         run_dir: Optional[str] = None,
                         max_velocity: float = 5.0) -> None:
    """Host-side abort gate: evaluate the state checks; on failure dump
    the state and raise SeaIceAbort."""
    raise_on_failed_checks(check_state(state, max_velocity=max_velocity),
                           state, timestamp, run_dir)
