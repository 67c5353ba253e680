"""Checkpoint and restart.

The port of the JAX package's `io/checkpoint.py`, the replacement for the
reference's Registry `restart` stream and its restart_timestamp protocol
(`mpas_seaice_core.F:341-354`, Registry.xml:1910-2014): the whole State
plus the clock is written bitwise to an npz file, under the same keys as
the JAX package (`velocity.<field>`, `tracers.<name>`, `time`,
`clock.<key>`), so a restart file of either package continues in the
other; an atomically replaced `restart_timestamp` text file names the
latest restart.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..dynamics.evp import VelocitySolverState
from ..model import State
from ..utils.device import resolve_device

VELOCITY_FIELDS = ("u_velocity", "v_velocity", "stress11", "stress22",
                   "stress12", "solve_velocity_prev")


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def flatten_state(state: State) -> Dict[str, np.ndarray]:
    """{checkpoint key: numpy array} of a State."""
    out = {f"velocity.{k}": _numpy(getattr(state.velocity, k))
           for k in VELOCITY_FIELDS}
    for k, arr in state.tracers.items():
        out[f"tracers.{k}"] = _numpy(arr)
    out["time"] = _numpy(state.time)
    return out


def atomic_savez(path: str, payload: Dict[str, np.ndarray]):
    """np.savez to a temporary file in the target's directory, then
    rename it over the target."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, state: State,
                    clock_metadata: Optional[Dict[str, Any]] = None):
    """Write the state bitwise to `path` (atomic: temp file + rename)."""
    payload = flatten_state(state)
    for k, v in (clock_metadata or {}).items():
        payload[f"clock.{k}"] = np.asarray(v)
    atomic_savez(path, payload)


def state_from_arrays(arrays: Dict[str, np.ndarray], dtype=None,
                      device=None) -> State:
    """A State from {checkpoint key: array}; floating arrays cast to
    dtype (a torch dtype) where given, on device (None: the GPU)."""
    device = resolve_device(device)

    def t(a):
        a = torch.from_numpy(np.array(a, order="C"))
        return a.to(device=device, dtype=dtype if dtype is not None
                    and a.is_floating_point() else None)

    vel = VelocitySolverState(**{k: t(arrays[f"velocity.{k}"])
                                 for k in VELOCITY_FIELDS})
    tracers = {k[len("tracers."):]: t(a) for k, a in arrays.items()
               if k.startswith("tracers.")}
    return State(velocity=vel, tracers=tracers, time=t(arrays["time"]))


def load_checkpoint(path: str, dtype=None, device=None
                    ) -> Tuple[State, Dict[str, Any]]:
    """Read a checkpoint back into a State (on device; None: the GPU)
    and its clock metadata dict."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    clock = {k[len("clock."):]: a for k, a in arrays.items()
             if k.startswith("clock.")}
    return state_from_arrays(arrays, dtype, device), clock


def write_restart_timestamp(run_dir: str, timestamp: str):
    """Atomically record the latest restart time
    (reference mpas_seaice_core.F:341-354)."""
    path = os.path.join(run_dir, "restart_timestamp")
    fd, tmp = tempfile.mkstemp(dir=run_dir)
    os.close(fd)
    with open(tmp, "w") as f:
        f.write(timestamp + "\n")
    os.replace(tmp, path)


def read_restart_timestamp(run_dir: str) -> Optional[str]:
    path = os.path.join(run_dir, "restart_timestamp")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()
