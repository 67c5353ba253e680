"""Parallel (per-block) I/O: gatherless restart and history streams.

The port of the JAX package's `io/parallel.py`, the replacement for the
reference's PIO-based parallel I/O (`config_pio_num_iotasks` /
`config_pio_stride`, Registry.xml:380-396, and the MPAS stream manager
writing each task's owned elements into shared NetCDF files).  Each
block writes its OWNED slice (halo rows are not written) to its own part
file, in the JAX package's layout, so a sharded restart of either
package loads into the other:

    <dir>/<name>.part-0003.npz       one per block
    <dir>/<name>.manifest.json       global sizes + block roster

Reads are halo-aware: a block's local arrays are filled from its own
part and from the parts of the blocks that own its halo cells.  A
partitioned state is the port's list of per-block States (the JAX
package stacks them on a shard axis); `assemble_*` rebuilds global
arrays for offline analysis.

Across ranks (`parallel/comm.py`) each rank writes the part files of its
own blocks (`shards`); rank 0 writes the manifest after a barrier, and a
second barrier holds every rank until it is there.  A rank reads its own
blocks back (`load_sharded_checkpoint(shards=...)`).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.partition import Partition
from .checkpoint import VELOCITY_FIELDS, atomic_savez, state_from_arrays


def _part_path(directory: str, name: str, shard: int) -> str:
    return os.path.join(directory, f"{name}.part-{shard:04d}.npz")


def _manifest_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"{name}.manifest.json")


def _write_manifest(path: str, manifest: Dict[str, Any]):
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    os.close(fd)
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)


def _owned_slice(part: Partition, s: int, kind: str, arr: np.ndarray,
                 i: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(owned rows, their global ids) of block s of a stacked
    [nBlocks, nLocal, ...] cell or vertex field, block s at position i
    (default s); pads (global id < 0) dropped."""
    i = s if i is None else i
    b = part.blocks[s]
    if kind == CELL:
        n, gid = b.n_cells_owned, b.cell_global
    else:
        n, gid = b.n_vertices_owned, b.vertex_global
    gid = gid[:n]
    ok = gid >= 0
    return np.asarray(arr[i, :n][ok]), gid[ok]


CELL, VERTEX = "cell", "vertex"
_VELOCITY_KINDS = {"u_velocity": VERTEX, "v_velocity": VERTEX,
                   "stress11": CELL, "stress22": CELL, "stress12": CELL,
                   "solve_velocity_prev": VERTEX}


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _positions(part: Partition, n_states: int, shards):
    """(block id, position in the states' list) of the blocks to write:
    a list of every block's states is indexed by block id, a list of
    some blocks' states (a rank's) holds `shards` in order."""
    if shards is None:
        shards = range(part.n_shards)
    shards = list(shards)
    if n_states == part.n_shards:
        return [(s, s) for s in shards]
    if n_states != len(shards):
        raise ValueError(f"{n_states} states for the blocks {shards}")
    return list(zip(shards, range(n_states)))


def _write_manifest_once(comm, path: str, manifest: Dict[str, Any]):
    """The manifest, written by rank 0 once every rank's parts are
    written (in one process: at once)."""
    if comm is not None:
        comm.barrier()
    if comm is None or comm.rank == 0:
        _write_manifest(path, manifest)
    if comm is not None:
        comm.barrier()


def _state_fields(states) -> List[Tuple[str, str, np.ndarray]]:
    """A partitioned State (list of blocks) as (name, kind, stacked
    [S, nLocal, ...] numpy array) triples, in the JAX package's order."""
    out = [(f"velocity.{k}", _VELOCITY_KINDS[k],
            np.stack([_numpy(getattr(st.velocity, k)) for st in states]))
           for k in VELOCITY_FIELDS]
    for k in states[0].tracers:
        out.append((f"tracers.{k}", CELL,
                    np.stack([_numpy(st.tracers[k]) for st in states])))
    return out


# -- restart write ------------------------------------------------------------

def save_sharded_checkpoint(directory: str, name: str, states,
                            part: Partition, n_cells_global: int,
                            n_vertices_global: int,
                            clock_metadata: Optional[Dict[str, Any]] = None,
                            shards: Optional[Sequence[int]] = None,
                            comm=None):
    """Write a partitioned State as one part file per block, owned rows
    only, bitwise.  states: one State per block, or (a rank's) one per
    block of `shards`; `shards`: which blocks to write (default: all).
    comm: the model's `parallel.comm.Comm` when every rank writes its own
    blocks (the manifest by rank 0, after a barrier)."""
    fields = _state_fields(states)
    # every block's time, [S], as the JAX package's stacked state has it;
    # the blocks step in lockstep, so a rank's blocks stand for the others
    local_time = np.stack([_numpy(st.time) for st in states])
    pos = _positions(part, len(states), shards)
    if len(states) == part.n_shards:
        time_val = local_time
    else:
        time_val = np.repeat(local_time[:1], part.n_shards, axis=0)
        time_val[[s for s, _ in pos]] = local_time
    for s, i in pos:
        payload: Dict[str, np.ndarray] = {}
        gids = {}
        for fname, kind, arr in fields:
            payload[f"{kind}:{fname}"], gids[kind] = _owned_slice(
                part, s, kind, arr, i)
        payload["cell_global"] = gids[CELL]
        payload["vertex_global"] = gids[VERTEX]
        payload["time"] = time_val
        atomic_savez(_part_path(directory, name, s), payload)
    _write_manifest_once(comm, _manifest_path(directory, name), {
        "n_shards": int(part.n_shards),
        "n_cells_global": int(n_cells_global),
        "n_vertices_global": int(n_vertices_global),
        "clock": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in (clock_metadata or {}).items()},
    })


# -- restart read (halo-aware, per block) -------------------------------------

class _PartCache:
    """Lazily opened part files with searchsorted row lookup (owned id
    lists are sorted per block: partition_mesh sorts them)."""

    def __init__(self, directory: str, name: str):
        self.directory = directory
        self.name = name
        self._open: Dict[int, Dict[str, np.ndarray]] = {}

    def part(self, s: int) -> Dict[str, np.ndarray]:
        if s not in self._open:
            with np.load(_part_path(self.directory, self.name, s)) as z:
                self._open[s] = {k: z[k] for k in z.files}
        return self._open[s]

    def rows(self, s: int, kind: str, field: str,
             gids: np.ndarray) -> np.ndarray:
        z = self.part(s)
        ids = z[f"{kind}_global"]
        pos = np.clip(np.searchsorted(ids, gids), 0, len(ids) - 1)
        if not np.array_equal(ids[pos], gids):
            raise ValueError(
                f"shard {s} part file does not own all requested "
                f"{kind} ids: partition mismatch with checkpoint")
        return z[f"{kind}:{field}"][pos]


def load_sharded_checkpoint(directory: str, name: str, part: Partition,
                            state_template,
                            shards: Optional[Sequence[int]] = None,
                            dtype=None, device=None):
    """Rebuild the per-block States of `part` from part files.

    Each local block takes its owned rows from its own part and its halo
    rows from the parts of the blocks that own them.  `state_template`
    (e.g. `model.init_state()`, a list of States) gives the fields and
    local shapes; `shards=None` loads all blocks.  Returns (list of
    States on device (None: the GPU), floating fields cast to dtype
    where given; the clock metadata dict)."""
    with open(_manifest_path(directory, name)) as f:
        manifest = json.load(f)
    if manifest["n_shards"] != part.n_shards:
        raise ValueError(
            f"checkpoint has {manifest['n_shards']} shards, partition "
            f"has {part.n_shards} (repartition restart requires "
            f"assemble_checkpoint + scatter)")
    cache = _PartCache(directory, name)
    if shards is None:
        shards = range(part.n_shards)
    fields = _state_fields(state_template)
    owner = {CELL: part.cell_owner, VERTEX: part.vertex_owner}
    states = []
    for s in shards:
        b = part.blocks[s]
        gid = {CELL: b.cell_global, VERTEX: b.vertex_global}
        arrays = {}
        for fname, kind, arr in fields:
            local = np.zeros(arr.shape[1:], arr.dtype)
            g = gid[kind]
            ok = g >= 0
            own = owner[kind][np.maximum(g, 0)]
            for src in np.unique(own[ok]):
                sel = ok & (own == src)
                local[sel] = cache.rows(int(src), kind, fname, g[sel])
            arrays[fname] = local
        t = cache.part(s)["time"]
        arrays["time"] = t[s] if t.ndim else t
        states.append(state_from_arrays(arrays, dtype, device))
    return states, manifest.get("clock", {})


def assemble_checkpoint(directory: str, name: str
                        ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Rebuild GLOBAL arrays from all part files (offline analysis /
    repartition path).  Returns ({field: global array}, clock)."""
    with open(_manifest_path(directory, name)) as f:
        manifest = json.load(f)
    sizes = {CELL: manifest["n_cells_global"],
             VERTEX: manifest["n_vertices_global"]}
    out: Dict[str, np.ndarray] = {}
    for s in range(manifest["n_shards"]):
        with np.load(_part_path(directory, name, s)) as z:
            ids = {k: z[f"{k}_global"] for k in (CELL, VERTEX)}
            for key in z.files:
                if ":" not in key:
                    continue
                kind, fname = key.split(":", 1)
                rows = z[key]
                if fname not in out:
                    out[fname] = np.zeros((sizes[kind],) + rows.shape[1:],
                                          rows.dtype)
                out[fname][ids[kind]] = rows
    return out, manifest.get("clock", {})


# -- history stream -----------------------------------------------------------

class ShardedOutputStream:
    """Per-block history stream: each output alarm appends the owned
    slice of the requested cell/vertex fields to an in-memory record;
    `flush()` writes one part file per block plus a manifest.
    `assemble_history` rebuilds the global [Time, nCells/nVertices, ...]
    arrays offline."""

    def __init__(self, directory: str, name: str, part: Partition,
                 n_cells_global: int, n_vertices_global: int):
        self.directory = directory
        self.name = name
        self.part = part
        self.shards: Optional[Sequence[int]] = None
        self.comm = None
        self.n_cells_global = n_cells_global
        self.n_vertices_global = n_vertices_global
        self.records: List[Dict[str, Tuple[str, np.ndarray]]] = []
        self.timestamps: List[str] = []

    def bind(self, model):
        """Take the blocks of a partitioned model's rank: `write` then
        takes that rank's blocks' fields, `flush` writes their part files
        and, across ranks, rank 0 the manifest once every rank's parts are
        written (`ShardedStandaloneRunner` binds its model)."""
        self.shards = list(model.block_ids)
        self.comm = model.comm

    def write(self, cell_fields: Dict[str, Any],
              vertex_fields: Dict[str, Any], timestamp: str):
        """fields: stacked [S, nLocal, ...] arrays, or lists of per-block
        tensors."""
        def stacked(v):
            if isinstance(v, (list, tuple)):
                return np.stack([_numpy(x) for x in v])
            return _numpy(v)

        rec: Dict[str, Tuple[str, np.ndarray]] = {}
        for k, v in cell_fields.items():
            rec[k] = (CELL, stacked(v))
        for k, v in vertex_fields.items():
            rec[k] = (VERTEX, stacked(v))
        self.records.append(rec)
        self.timestamps.append(timestamp)

    def flush(self, shards: Optional[Sequence[int]] = None):
        if not self.records:
            return
        part = self.part
        n_states = len(next(iter(self.records[0].values()))[1])
        if shards is None:
            shards = self.shards
        for s, i in _positions(part, n_states, shards):
            payload: Dict[str, np.ndarray] = {}
            for key, (kind, _a) in self.records[0].items():
                stackrows = []
                for rec in self.records:
                    rows, gid = _owned_slice(part, s, kind, rec[key][1], i)
                    stackrows.append(rows)
                payload[f"{kind}:{key}"] = np.stack(stackrows)
                payload[f"{kind}_global"] = gid
            payload["xtime"] = np.array(self.timestamps)
            atomic_savez(_part_path(self.directory, self.name, s), payload)
        _write_manifest_once(self.comm, _manifest_path(self.directory,
                                                       self.name), {
            "n_shards": int(part.n_shards),
            "n_cells_global": int(self.n_cells_global),
            "n_vertices_global": int(self.n_vertices_global),
            "n_records": len(self.records),
        })


def assemble_history(directory: str, name: str
                     ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Global [Time, nGlobal, ...] arrays from a ShardedOutputStream."""
    with open(_manifest_path(directory, name)) as f:
        manifest = json.load(f)
    sizes = {CELL: manifest["n_cells_global"],
             VERTEX: manifest["n_vertices_global"]}
    out: Dict[str, np.ndarray] = {}
    xtime: List[str] = []
    for s in range(manifest["n_shards"]):
        with np.load(_part_path(directory, name, s)) as z:
            ids = {k: z[f"{k}_global"] for k in (CELL, VERTEX)
                   if f"{k}_global" in z.files}
            if not xtime:
                xtime = [str(t) for t in z["xtime"]]
            for key in z.files:
                if ":" not in key:
                    continue
                kind, fname = key.split(":", 1)
                rows = z[key]                    # [Time, nOwned, ...]
                if fname not in out:
                    out[fname] = np.zeros(
                        (rows.shape[0], sizes[kind]) + rows.shape[2:],
                        rows.dtype)
                out[fname][:, ids[kind]] = rows
    return out, xtime
