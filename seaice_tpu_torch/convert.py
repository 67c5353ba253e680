"""State and static tensors carried across from the JAX package.

The system has no weights; what has to agree between the two packages is
the static per-mesh data (`ModelTensors`), the prognostic state (`State`,
with every tracer of the tree: the full-physics state carries its
thermodynamic and pond tracers the same way) and the forcing
(`DynamicsForcing`, and for the column physics `AtmosForcing` and
`OceanForcing`).  `flatten_arrays` turns any container of
arrays (a dataclass, a dict, nested) into {dotted name: numpy array};
`from_reference_arrays` builds the port's containers from such
dictionaries.  For a partitioned mesh the JAX package stacks every block
on a leading shard axis and the port keeps a list, one container per
block: `from_sharded_reference_arrays` and `to_stacked_arrays` carry
between the two.  The tests use these to feed both packages the same
inputs.  Nothing here imports the JAX package: a reference object is
walked by `dataclasses.fields` and read through `numpy.asarray`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .column.driver import AtmosForcing, OceanForcing
from .dynamics.evp import (DynamicsForcing, DynamicsTensors,
                           VelocitySolverState)
from .dynamics.variational_fast import FastTensors
from .dynamics.variational_panel import PanelTensors, kernel_index_lists
from .mesh.core import MeshTensors
from .model import ModelTensors, State
from .transport.geometry import RemapTensors

# nested containers by (class, field name)
_NESTED = {
    (ModelTensors, "mesh"): MeshTensors,
    (ModelTensors, "dynamics"): DynamicsTensors,
    (ModelTensors, "remap"): RemapTensors,
    (DynamicsTensors, "mesh"): MeshTensors,
    (DynamicsTensors, "fast"): FastTensors,
    (DynamicsTensors, "panel"): PanelTensors,
    (State, "velocity"): VelocitySolverState,
}


def flatten_arrays(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """{dotted.name: numpy array} of every array leaf of `obj`."""
    out = {}
    if obj is None:
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            out.update(flatten_arrays(getattr(obj, f.name),
                                      prefix + f.name + "."))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(flatten_arrays(v, prefix + str(k) + "."))
    elif isinstance(obj, torch.Tensor):
        out[prefix[:-1]] = obj.detach().cpu().numpy()
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        out[prefix[:-1]] = np.asarray(obj)
    return out


def _tensor(a, device, dtype):
    a = np.array(a, order="C")      # a copy; keeps 0-d arrays 0-d
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64)).to(device)
    if a.dtype.kind == "b":
        return torch.as_tensor(a).to(device)
    return torch.as_tensor(a.astype(np.float64)).to(device=device,
                                                    dtype=dtype)


def _build(cls, arrays, prefix, device, dtype):
    has = [k for k in arrays if k.startswith(prefix)]
    if not has:
        return None
    kw = {}
    for f in dataclasses.fields(cls):
        nested = _NESTED.get((cls, f.name))
        key = prefix + f.name
        if nested is not None:
            kw[f.name] = _build(nested, arrays, key + ".", device, dtype)
        elif cls is State and f.name == "tracers":
            kw[f.name] = {k[len(key) + 1:]: _tensor(v, device, dtype)
                          for k, v in arrays.items()
                          if k.startswith(key + ".")}
        elif key in arrays:
            kw[f.name] = _tensor(arrays[key], device, dtype)
        else:
            kw[f.name] = None
    if cls is FastTensors:
        # the kernel's int32 copies of the two index tables
        kw["voc_T_i32"] = kw["voc_T"].to(torch.int32)
        kw["flat_corner_idx_i32"] = kw["flat_corner_idx"].to(torch.int32)
    if cls is PanelTensors:
        # the kernels' int32 index lists, derived from the carried maps
        return kernel_index_lists(cls(**kw))
    return cls(**kw)


def from_reference_arrays(tensors_np: Optional[Dict[str, np.ndarray]],
                          state_np: Optional[Dict[str, np.ndarray]],
                          device, dtype,
                          forcing_np: Optional[Dict[str, np.ndarray]] = None):
    """Build the port's (ModelTensors, State, DynamicsForcing) from the
    JAX package's `ModelTensors` / `State` / `DynamicsForcing` flattened
    by `flatten_arrays`.  A part passed as None comes back as None.
    Fields the port does not have (the weak-scheme and gather-plan
    tensors) are ignored; integer arrays become int64 index tensors."""
    tensors = state = forcing = None
    if tensors_np is not None:
        tensors = _build(ModelTensors, tensors_np, "", device, dtype)
    if state_np is not None:
        state = _build(State, state_np, "", device, dtype)
    if forcing_np is not None:
        forcing = _build(DynamicsForcing, forcing_np, "", device, dtype)
    return tensors, state, forcing


def column_forcing_from_reference_arrays(
        atmos_np: Dict[str, np.ndarray], ocean_np: Dict[str, np.ndarray],
        device, dtype):
    """The port's (AtmosForcing, OceanForcing) from the JAX package's
    column forcing flattened by `flatten_arrays`."""
    return (_build(AtmosForcing, atmos_np, "", device, dtype),
            _build(OceanForcing, ocean_np, "", device, dtype))


def from_sharded_reference_arrays(
        state_np: Optional[Dict[str, np.ndarray]], device, dtype,
        forcing_np: Optional[Dict[str, np.ndarray]] = None):
    """The JAX package's sharded `State` / `DynamicsForcing`, flattened by
    `flatten_arrays` (every array [S, ...]), as the port's per-block lists
    (states, forcings); a part passed as None comes back as None."""
    def blocks(arrays):
        n = {a.shape[0] for a in arrays.values()}
        if len(n) != 1:
            raise ValueError(f"shard axes of different lengths: {n}")
        return [{k: a[s] for k, a in arrays.items()} for s in range(n.pop())]

    states = forcings = None
    if state_np is not None:
        states = [from_reference_arrays(None, b, device, dtype)[1]
                  for b in blocks(state_np)]
    if forcing_np is not None:
        forcings = [from_reference_arrays(None, None, device, dtype, b)[2]
                    for b in blocks(forcing_np)]
    return states, forcings


def to_stacked_arrays(objs: List) -> Dict[str, np.ndarray]:
    """The port's per-block containers as {dotted.name: [S, ...] numpy
    array}, the JAX package's stacked layout."""
    flat = [flatten_arrays(o) for o in objs]
    return {k: np.stack([f[k] for f in flat]) for k in flat[0]}
