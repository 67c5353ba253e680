"""Partitioned sea-ice model: the mesh split into blocks, stepped in one
process or across processes, one rank per card.

The port of the JAX package's `parallel/sharded.py`, the replacement for
the reference's MPI block loop + dmpar halo exchange.  Each block runs the
single-block step on its local mesh (owned + 2-deep halo, the MPAS block
structure; `partition.py`), and the halos are refreshed inside the step:

  per elastic subcycle: the vertex-velocity halo (the reference exchanges
    uVelocity/vVelocity once per subcycle,
    mpas_seaice_velocity_solver.F:2546-2584), between calls of the
    one-subcycle EVP kernel `evp_subcycle_step`, one call for all the
    blocks of the rank (`evp_subcycle`);
  before the loop: the solveStress / solveVelocity masks and (u, v);
  per dynamics subcycle: the 2-deep cell halo of every tracer after
    transport (reference ...incremental_remap.F:2429-2487).

The JAX package runs the blocks as SPMD under `shard_map`, each exchange a
collective inside the per-block body.  Here the SPMD unit is a process
under `torch.distributed` (`comm.py`): under an initialised process group
of W ranks, rank r holds blocks [r k, (r+1) k) (k = n_shards / W) on its
own card; without one, every block is in this process (W = 1).  Within a
rank the per-block body is a generator that stops at each exchange
(`utils/lockstep.py`); the step advances the rank's blocks to the same
exchange point, refreshes the halos in place, and resumes them.  Every
rank reaches the same exchanges in the same order.

An exchange fills every halo slot from the blocks' export buffers (their
owned entities that other blocks need) through a table fixed when the
model is built:

  "allgather": slot <- buffers[src_shard][src_idx], every block shipping
    its exports to all; a padded halo slot (global id -1) takes entry
    (0, 0), as the JAX package's `_gather_halo` gives it;
  "ring": the block-neighbour graph edge-coloured into rounds of
    (src, dst) copies (`color_halo_graph`); in round ci block dst takes
    src's buffer at its halo slots of colour ci.  In one process a round's
    copy is a reference, so the rounds are resolved into the table; padded
    slots (colour -1) stay zero, as `_perm_halo` leaves them.  Across
    ranks the rank-neighbour graph is coloured in the same way and each
    exchange sends each peer rank one packed buffer (`comm.HaloPlan`).

Both give every real halo slot the same value, bitwise, in one process
and across ranks.

`overlap=True` is the JAX package's interior/boundary overlap of the
vertex exchange (`seaice_tpu/parallel/sharded.py:140-167`): each subcycle
first computes the export vertices' new velocities through a small subset
pipeline (`evp.subcycle_exports`), starts their exchange, runs K6 for
all the rank's blocks, waits, and then gives the owned export vertices the
subset values and the halo slots the received ones (`evp_overlap`).

Every option of the velocity solve runs on the blocks: standard EVP by
K6, each solver variant by its plain-torch loop (`evp.variant_subcycles`)
with the vertex halo exchanged after every subcycle, revised EVP with the
global minimum edge length.  Upwind advection raises ValueError: the JAX
package's sharded step advects only by incremental remapping and skips
transport under upwind (ROADMAP Queue 3, fault 10).

With the column package each block runs the column physics on all its
local cells (owned and halo), as the JAX package's `shard_body` does:
thermodynamics before the dynamics, the Rothrock strength and the
ridging inside each dynamics subcycle, the post-dynamics phase after.
The column is per cell and a halo cell carries the same tracers and
forcing as its owner, so no exchange is added: the tracer halo refresh
after each remap already carries every tracer.  `full_physics_inputs`
is the port's copy of the JAX package's full-physics initial state and
forcing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..config import (AdvectionType, Config, ConstitutiveRelation,
                      StrainScheme, StressDivergenceScheme)
from ..diagnostics import span
from ..dynamics import evp
from ..dynamics.cuda_unstructured import (evp_subcycle_share_uv,
                                          evp_subcycle_step)
from ..mesh.core import Mesh
from ..model import (SeaIceModel, State, check_kernel_options,
                     column_after_dynamics, column_before_dynamics,
                     dynamics_transport_steps)
from ..transport.remap import make_remap_step
from ..utils.containers import tensor_dataclass
from ..utils.device import resolve_device
from ..utils.lockstep import drive_lockstep
from .comm import Comm, build_halo_plan, color_halo_graph, process_group
from .partition import partition_mesh

@tensor_dataclass
class HaloMaps:
    """One block's halo bookkeeping, on the block's device: the JAX
    package's per-shard slice of its stacked `HaloMaps`, without the
    gather-plan coordinates (the port's EVP kernels keep vertices in mesh
    order, so the halo vertices are `[n_vertices_owned:]`), and with the
    gather table of the halo mode."""
    vertex_export_idx: Any        # [nVertexExport] local owned indices
    vertex_halo_src_shard: Any    # [nVertexHalo]
    vertex_halo_src_idx: Any
    cell_export_idx: Any          # [nCellExport]
    cell_halo_src_shard: Any      # [nCellHalo]
    cell_halo_src_idx: Any
    vertex_owned_mask: Any        # [nVerticesOwned]
    cell_owned_mask: Any          # [nCellsOwned]
    vertex_halo_color: Any        # [nVertexHalo] ring round, -1 padding
    cell_halo_color: Any          # [nCellHalo]
    vertex_halo_gather: Any       # [nVertexHalo] into the concatenated
    cell_halo_gather: Any         # export buffers + one zero entry


def halo_gather_table(halo_mode, s, src_shard, src_idx, color, perms,
                      n_export, n_shards):
    """Block s's halo slots as indices into the concatenation of every
    block's export buffer (n_export entries each) followed by one zero
    entry.  "allgather" addresses (src_shard, src_idx) for every slot;
    "ring" walks the rounds: in round ci the block receiving in a pair
    (r, s) takes r's buffer at its slots of colour ci, and slots no round
    fills keep the zero entry."""
    if halo_mode == "allgather":
        return src_shard.astype(np.int64) * n_export + src_idx
    if halo_mode != "ring":
        raise ValueError(f"halo_mode {halo_mode!r}: 'ring' or 'allgather'")
    table = np.full(len(color), n_shards * n_export, np.int64)
    for ci, perm in enumerate(perms):
        for r, dst in perm:
            if dst == s:
                sel = color == ci
                table[sel] = r * n_export + src_idx[sel]
    return table


def rank_device(devices, world: int, rank: int) -> torch.device:
    """The device of this rank's blocks: None, the rank's own card
    (`resolve_device`); one device; or a list of devices that names one
    device, or holds one device per rank."""
    if not isinstance(devices, (list, tuple)):
        return resolve_device(devices)
    names = [resolve_device(d) for d in devices]
    if len(set(names)) == 1:
        return names[0]
    if len(names) != world:
        raise ValueError(
            f"devices names {len(set(names))} cards for {world} "
            "process(es): one process holds one card; launch one process "
            "per card (python -m torch.distributed.run "
            "--nproc-per-node=N ...), each with its own card, or pass a "
            "list of one device per rank")
    return names[rank]


class ShardedSeaIceModel:
    """The model on a partitioned mesh: same Config and semantics as
    SeaIceModel; `models`, `tensors`, `halo`, and the states and forcings
    the step takes and returns are lists of this rank's blocks (the JAX
    package stacks them on a shard axis); `block_ids` names them."""

    def __init__(self, mesh: Mesh, cfg: Config, n_shards: int,
                 dtype=torch.float32, devices=None,
                 halo_mode: str = "ring", overlap: bool = False,
                 tracer_tree=None, group=None):
        """devices: None (the rank's card, or an error without one), one
        device, a list of devices that names one device, or a list of one
        device per rank.  halo_mode: "ring" (rounds of neighbour copies,
        default) or "allgather".  overlap: the interior/boundary overlap
        of the vertex exchange where the configuration allows it
        (`overlap_enabled`).  tracer_tree: as `SeaIceModel` takes it.
        group: a `torch.distributed` process group (None: the default
        group where one is initialised, else this process alone); its
        world size must divide n_shards."""
        if cfg.advection.advection_type == AdvectionType.UPWIND:
            raise ValueError(
                "upwind advection on a partitioned mesh: the JAX "
                "package's sharded step advects only by incremental "
                "remapping and leaves the tracers unmoved under upwind; "
                "the port does not copy a step that drops transport "
                "(ROADMAP Queue 3, fault 10)")
        group = process_group(group)
        world = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        if n_shards % world:
            raise ValueError(
                f"{n_shards} blocks on {world} ranks: n_shards must be a "
                "multiple of the world size")
        k = n_shards // world
        self.block_ids = range(rank * k, (rank + 1) * k)
        self.device = rank_device(devices, world, rank)
        self.comm = Comm(group, self.device)
        self.global_mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.halo_mode = halo_mode
        # the interior/boundary overlap where the JAX package runs it
        # (`seaice_tpu/parallel/sharded.py:161-167`)
        v = cfg.velocity
        self.overlap_enabled = bool(
            overlap and v.use_velocity_solver
            and v.strain_scheme == StrainScheme.VARIATIONAL
            and v.stress_divergence_scheme ==
            StressDivergenceScheme.VARIATIONAL
            and v.constitutive_relation == ConstitutiveRelation.EVP
            and not v.include_metric_terms
            and not v.average_variational_strains)
        if self.overlap_enabled:
            evp.check_overlap(cfg)
        self.part = partition_mesh(mesh, n_shards)
        self.n_shards = n_shards
        self.blocks = [self.part.blocks[s] for s in self.block_ids]
        self.models = [SeaIceModel(b.mesh, cfg, dtype, device=self.device,
                                   tracer_tree=tracer_tree)
                       for b in self.blocks]
        self.tree = self.models[0].tree
        self.tensors = [m.tensors for m in self.models]

        # edge-colour the block-neighbour graph into rounds; padded halo
        # slots (global id -1) are not real edges: colour -1
        def halo_valid(b):
            return (b.cell_global[b.n_cells_owned:] >= 0,
                    b.vertex_global[b.n_vertices_owned:] >= 0)

        edges = set()
        for s, b in enumerate(self.part.blocks):
            cv, vv = halo_valid(b)
            for r in np.unique(b.cell_halo_src_shard[cv]):
                edges.add((int(r), s))
            for r in np.unique(b.vertex_halo_src_shard[vv]):
                edges.add((int(r), s))
        self.halo_perms, color_of = color_halo_graph(edges, n_shards)

        def colors(src_shards, valid, s):
            return np.array(
                [color_of[(int(r), s)] if ok else -1
                 for r, ok in zip(src_shards, valid)], np.int32)

        def ix(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(self.device)

        def fl(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(
                device=self.device, dtype=dtype)

        # every block's colours and one-process gather tables (the plans
        # of the ranks are built from all of them)
        cols, tables = [], {"vertex": [], "cell": []}
        for s, b in enumerate(self.part.blocks):
            cv, vv = halo_valid(b)
            cols.append((colors(b.vertex_halo_src_shard, vv, s),
                         colors(b.cell_halo_src_shard, cv, s)))
            for kind, col in zip(("vertex", "cell"), cols[-1]):
                tables[kind].append(halo_gather_table(
                    halo_mode, s, getattr(b, f"{kind}_halo_src_shard"),
                    getattr(b, f"{kind}_halo_src_idx"), col,
                    self.halo_perms, len(getattr(b, f"{kind}_export_idx")),
                    n_shards))
        self.halo = [HaloMaps(
            vertex_export_idx=ix(b.vertex_export_idx),
            vertex_halo_src_shard=ix(b.vertex_halo_src_shard),
            vertex_halo_src_idx=ix(b.vertex_halo_src_idx),
            cell_export_idx=ix(b.cell_export_idx),
            cell_halo_src_shard=ix(b.cell_halo_src_shard),
            cell_halo_src_idx=ix(b.cell_halo_src_idx),
            vertex_owned_mask=fl(b.vertex_owned_mask),
            cell_owned_mask=fl(b.cell_owned_mask),
            vertex_halo_color=ix(cols[s][0]), cell_halo_color=ix(cols[s][1]),
            vertex_halo_gather=ix(tables["vertex"][s]),
            cell_halo_gather=ix(tables["cell"][s]))
            for s, b in zip(self.block_ids, self.blocks)]
        self.n_vertices_owned = self.part.blocks[0].n_vertices_owned
        self.n_cells_owned = self.part.blocks[0].n_cells_owned
        # the rank's exchanges of each kind (`comm.HaloPlan`): every
        # exchange across ranks, and the overlapped vertex exchange
        self.plans = {kind: build_halo_plan(
            halo_mode, tables[kind],
            len(getattr(self.part.blocks[0], f"{kind}_export_idx")), rank,
            world, self.device) for kind in ("vertex", "cell")}
        # the K6 loops' shared velocity buffer [2, k*nv + 1]
        # (`evp_subcycle_share_uv`): block b's vertex i at b*nv + i; in one
        # process the vertex halo of every block is one gather and one
        # scatter on it (the tables composed with the export lists, the
        # zero entry of the ring at k*nv), across ranks and under the
        # overlap its export rows and halo slots
        nv = self.part.blocks[0].mesh.n_vertices
        if any(b.mesh.n_vertices != nv for b in self.part.blocks):
            raise ValueError("blocks of unequal vertex counts")
        exp = np.stack([b.vertex_export_idx for b in self.part.blocks])
        n_exp = exp.shape[1]
        n_halo = nv - self.n_vertices_owned
        self.uv_export_pos = ix(np.concatenate(
            [b * nv + exp[s] for b, s in enumerate(self.block_ids)]))
        self.uv_halo_pos = ix(np.concatenate(
            [b * nv + self.n_vertices_owned + np.arange(n_halo)
             for b in range(k)]))
        if self.comm.route == "in-process":
            src = []
            for t in tables["vertex"]:
                r, j = np.divmod(np.minimum(t, n_shards * n_exp - 1), n_exp)
                src.append(np.where(t == n_shards * n_exp, n_shards * nv,
                                    r * nv + exp[r, j]))
            self.uv_halo_src = ix(np.concatenate(src))
        # the overlap's subset tensors, per block
        self.overlap = None
        if self.overlap_enabled:
            self.overlap = [evp.build_subcycle_overlap(
                b.mesh, m.tensors.dynamics.fast, b.vertex_export_idx, dtype,
                self.device) for b, m in zip(self.blocks, self.models)]

    # -- state scatter/gather ------------------------------------------------

    def local_blocks(self, stacked):
        """This rank's blocks of a stacked [S, ...] host array."""
        return stacked[self.block_ids.start:self.block_ids.stop]

    def init_state(self, ice_area_cat=None, ice_volume_cat=None,
                   snow_volume_cat=None) -> List[State]:
        def sc(f):
            if f is None:
                return [None] * len(self.blocks)
            return self.local_blocks(
                self.part.scatter_cell_field(np.asarray(f)))

        return [m.init_state(a, v, sn) for m, a, v, sn in zip(
            self.models, sc(ice_area_cat), sc(ice_volume_cat),
            sc(snow_volume_cat))]

    def scatter_forcing(self, forcing_fn):
        """forcing_fn(local_mesh) -> DynamicsForcing; one per block."""
        return [forcing_fn(b.mesh) for b in self.blocks]

    def scatter_cell_tree(self, tree):
        """A container of global [nCells, ...] fields (an array, a tensor,
        a dict, or a dataclass such as DynamicsForcing) -> one container
        per block of the rank, on the blocks' device; floating fields in
        the model's dtype."""
        n = len(self.blocks)
        if tree is None:
            return [None] * n
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            parts = {f.name: self.scatter_cell_tree(getattr(tree, f.name))
                     for f in dataclasses.fields(tree)}
            return [dataclasses.replace(tree, **{k: p[s]
                                                 for k, p in parts.items()})
                    for s in range(n)]
        if isinstance(tree, dict):
            parts = {k: self.scatter_cell_tree(v) for k, v in tree.items()}
            return [{k: p[s] for k, p in parts.items()} for s in range(n)]
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        local = self.local_blocks(
            self.part.scatter_cell_field(np.asarray(tree)))
        out = [torch.as_tensor(a).to(self.device) for a in local]
        return [t.to(self.dtype) if t.is_floating_point() else t
                for t in out]

    def scatter_cells(self, tree):
        """A container of global [nCells, ...] tensors already on the
        device (a tensor, a dict, or a dataclass such as DynamicsForcing)
        -> one container per block of the rank, each block's cells taken
        on the device, padded cells zero (the device counterpart of
        `scatter_cell_tree`, bitwise)."""
        n = len(self.blocks)
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            parts = {f.name: self.scatter_cells(getattr(tree, f.name))
                     for f in dataclasses.fields(tree)}
            return [dataclasses.replace(tree, **{k: p[s]
                                                 for k, p in parts.items()})
                    for s in range(n)]
        if isinstance(tree, dict):
            parts = {k: self.scatter_cells(v) for k, v in tree.items()}
            return [{k: p[s] for k, p in parts.items()} for s in range(n)]
        cache = self.__dict__.setdefault("_scatter_cache", [])
        if not cache:
            for b in self.blocks:
                gid = torch.as_tensor(b.cell_global.astype(np.int64)).to(
                    self.device)
                cache.append((gid.clamp(min=0), gid >= 0))
        out = []
        for idx, valid in cache:
            loc = tree.index_select(0, idx)
            valid = valid.reshape(valid.shape + (1,) * (loc.ndim - 1))
            out.append(torch.where(valid, loc, torch.zeros_like(loc)))
        return out

    def _owner_rows(self, kind: str):
        """(per block of the rank, its owned rows of `kind` ("cell" or
        "vertex") as (local rows, global rows) device index tensors; the
        rows every rank contributes to a gather across ranks, padded to
        the largest rank's count: (that count, the positions of the real
        rows in the gathered rows, their global rows)), cached."""
        cache = self.__dict__.setdefault("_owner_row_cache", {})
        if kind not in cache:
            rows = []
            for b in self.part.blocks:
                n = (b.n_cells_owned if kind == "cell"
                     else b.n_vertices_owned)
                gid = getattr(b, f"{kind}_global")[:n]
                loc = np.nonzero(gid >= 0)[0]
                rows.append((loc, gid[loc]))
            k, world = len(self.blocks), self.comm.world_size
            counts = [sum(len(rows[s][0]) for s in range(r * k, (r + 1) * k))
                      for r in range(world)]
            n_max = max(counts)
            pos = np.concatenate([r * n_max + np.arange(c)
                                  for r, c in enumerate(counts)])

            def ix(a):
                return torch.as_tensor(np.asarray(a, np.int64)).to(
                    self.device)

            cache[kind] = (
                [(ix(rows[s][0]), ix(rows[s][1])) for s in self.block_ids],
                (n_max, ix(pos), ix(np.concatenate([g for _, g in rows]))))
        return cache[kind]

    def _gather_fields(self, kind: str, n_global: int, fields):
        """fields: a list of fields, each a list of the rank's blocks'
        [nLocal, ...] tensors -> for each field the global [n_global, ...]
        tensor on the device, each row from its owner (bitwise: copies
        only).  The rank's owned rows of every field of one dtype go in
        one packed buffer, all-gathered across ranks (in one process the
        buffer itself), so that every rank gets the whole fields."""
        mine, (n_max, pos, gid_all) = self._owner_rows(kind)
        out = [None] * len(fields)
        by_dtype = {}
        for i, blocks in enumerate(fields):
            by_dtype.setdefault(blocks[0].dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            flat = [[t.reshape(t.shape[0], math.prod(t.shape[1:]))
                     for t in fields[i]] for i in idx]
            cols = np.cumsum([0] + [f[0].shape[1] for f in flat])
            buf = torch.zeros((n_max, int(cols[-1])), dtype=dtype,
                              device=self.device)
            for j, blocks in enumerate(flat):
                buf[:sum(len(loc) for loc, _ in mine),
                    cols[j]:cols[j + 1]] = torch.cat(
                        [t.index_select(0, loc)
                         for (loc, _), t in zip(mine, blocks)])
            rows = self.comm.all_gather(buf).index_select(0, pos)
            for j, i in enumerate(idx):
                shape = tuple(fields[i][0].shape[1:])
                g = torch.zeros((n_global, int(cols[j + 1] - cols[j])),
                                dtype=dtype, device=self.device)
                g.index_copy_(0, gid_all, rows[:, cols[j]:cols[j + 1]])
                out[i] = g.reshape((n_global,) + shape)
        return out

    def gather_cells(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        """The rank's blocks' [nCellsLocal, ...] tensors -> the global
        [nCells, ...] tensor on the device, each cell from its owner (the
        device counterpart of `part.gather_cell_field`, bitwise); across
        ranks a collective: every rank calls it and gets the whole
        field."""
        return self._gather_fields("cell", self.global_mesh.n_cells,
                                   [blocks])[0]

    def gather_vertices(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        return self._gather_fields("vertex", self.global_mesh.n_vertices,
                                   [blocks])[0]

    def gather_state(self, states: List[State]) -> State:
        """The blocks' states -> one State of the whole mesh on the
        device (a collective across ranks): the velocities and the
        tracers from their owners; the corner stresses, in each block's
        own corner order, are left out (None), as the JAX package's
        sharded coupled driver leaves them."""
        names = ("u_velocity", "v_velocity", "solve_velocity_prev")
        vert = self._gather_fields(
            "vertex", self.global_mesh.n_vertices,
            [[getattr(st.velocity, k) for st in states] for k in names])
        tr = list(states[0].tracers)
        cells = self._gather_fields(
            "cell", self.global_mesh.n_cells,
            [[st.tracers[k] for st in states] for k in tr])
        return State(
            velocity=states[0].velocity.replace(
                stress11=None, stress22=None, stress12=None,
                **dict(zip(names, vert))),
            tracers=dict(zip(tr, cells)), time=states[0].time)

    def gather_tracers(self, states: List[State]) -> Dict[str, np.ndarray]:
        """Every tracer of the whole mesh, numpy (a collective across
        ranks)."""
        tr = list(states[0].tracers)
        cells = self._gather_fields(
            "cell", self.global_mesh.n_cells,
            [[st.tracers[k] for st in states] for k in tr])
        return {k: t.cpu().numpy() for k, t in zip(tr, cells)}

    def gather_velocity(self, states: List[State]):
        """(u, v) of the whole mesh, numpy (a collective across ranks)."""
        u, v = self._gather_fields(
            "vertex", self.global_mesh.n_vertices,
            [[getattr(st.velocity, k) for st in states]
             for k in ("u_velocity", "v_velocity")])
        return u.cpu().numpy(), v.cpu().numpy()

    # -- halo exchange and step ---------------------------------------------

    def exchange(self, kind: str, fields_per_block, halo=None, solve=None):
        """Refresh, in place, the halo entries of every block's fields:
        fields_per_block[b] is a tuple of the rank's block b's cell fields
        (kind "cell_field") or vertex fields ("vertex_field",
        "vertex_uv"), each [nLocal, ...].  halo: the blocks' HaloMaps
        (default: the model's; across ranks only the model's).  solve: the
        velocity solve under way (`evp_subcycle`); where the fields are its
        loops' velocities, held in one buffer, the exchange works on that
        buffer."""
        halo = self.halo if halo is None else halo
        if kind == "vertex_uv" and solve and halo is self.halo and all(
                f[0] is lp.u and f[1] is lp.v
                for f, lp in zip(fields_per_block, solve["loops"])):
            self.exchange_uv(solve["uv"])
            return
        if self.comm.route != "in-process":
            if halo is not self.halo:
                raise ValueError("across ranks an exchange takes the "
                                 "model's own halo maps")
            self._exchange_packed(
                "cell" if kind == "cell_field" else "vertex",
                fields_per_block)
            return
        if kind == "cell_field":
            n_own = self.n_cells_owned
            export = [h.cell_export_idx for h in halo]
            table = [h.cell_halo_gather for h in halo]
        else:
            n_own = self.n_vertices_owned
            export = [h.vertex_export_idx for h in halo]
            table = [h.vertex_halo_gather for h in halo]
        n_exp = export[0].shape[0]
        for j in range(len(fields_per_block[0])):
            f0 = fields_per_block[0][j]
            buf = torch.empty((len(halo) * n_exp + 1,) + f0.shape[1:],
                              dtype=f0.dtype, device=f0.device)
            for s, fields in enumerate(fields_per_block):
                torch.index_select(fields[j], 0, export[s],
                                   out=buf[s * n_exp:(s + 1) * n_exp])
            buf[-1].zero_()
            for s, fields in enumerate(fields_per_block):
                torch.index_select(buf, 0, table[s],
                                   out=fields[j][n_own:])

    def _exchange_packed(self, kind: str, fields_per_block):
        """The exchange across ranks: every field's export rows of the
        rank's blocks packed into one buffer [k nExport, F], the plan's
        transport, then each block's halo slots from the full buffer."""
        n_own = (self.n_cells_owned if kind == "cell"
                 else self.n_vertices_owned)
        export = [getattr(h, f"{kind}_export_idx") for h in self.halo]
        n_exp = export[0].shape[0]
        flat = [[f.view(f.shape[0], -1) for f in fields]
                for fields in fields_per_block]
        dtypes = {f.dtype for fields in flat for f in fields}
        if len(dtypes) != 1:
            raise ValueError(f"one exchange packs one dtype, not {dtypes}")
        cols = np.cumsum([0] + [f.shape[1] for f in flat[0]])
        exports = torch.empty((len(flat) * n_exp, int(cols[-1])),
                              dtype=dtypes.pop(), device=self.device)
        for b, fields in enumerate(flat):
            rows = exports[b * n_exp:(b + 1) * n_exp]
            for j, f in enumerate(fields):
                rows[:, cols[j]:cols[j + 1]] = f.index_select(0, export[b])
        plan = self.plans[kind]
        full = self.comm.exchange(plan, exports)
        for b, fields in enumerate(flat):
            slots = full.index_select(0, plan.table[b])
            for j, f in enumerate(fields):
                f[n_own:].copy_(slots[:, cols[j]:cols[j + 1]])

    def exchange_uv(self, uv):
        """The vertex halo of the K6 loops' shared velocity buffer uv
        [2, k*nv + 1], in place: in one process one gather and one
        scatter; across ranks its export rows packed [k nExport, 2], the
        transport, and every halo slot from the full buffer."""
        if self.comm.route == "in-process":
            uv.index_copy_(1, self.uv_halo_pos,
                           uv.index_select(1, self.uv_halo_src))
        else:
            self._fill_uv_halo(uv, self.comm.exchange(
                self.plans["vertex"],
                uv.t().index_select(0, self.uv_export_pos)))

    def _fill_uv_halo(self, uv, full):
        """Every halo slot of the shared velocity buffer from the full
        buffer of a vertex exchange."""
        slots = full.index_select(0, self.plans["vertex"].table.reshape(-1))
        uv.index_copy_(1, self.uv_halo_pos, slots.t())

    def _share(self, loops, solve):
        loops = tuple(loops)
        if solve is not None and solve.get("loops") != loops:
            solve["loops"], solve["uv"] = loops, evp_subcycle_share_uv(loops)
        return loops

    def evp_subcycle(self, loops, solve=None):
        """One elastic subcycle of every block's velocity solve: the K6
        loops of the rank's blocks, in block order, in one call.
        solve: a dict for the solve under way; at its first subcycle the
        loops' velocities move into one buffer (`evp_subcycle_share_uv`),
        on which `exchange` then works."""
        evp_subcycle_step(*self._share(loops, solve))

    def evp_overlap(self, loops, exports, solve):
        """One elastic subcycle under the interior/boundary overlap: the
        blocks' export rows [nExport, 2] (the subset pipeline's new u, v,
        `evp.subcycle_exports`) are packed and their exchange started,
        the K6 call for all the rank's blocks runs on the current stream,
        the exchange is waited for, then the owned export vertices take
        the subset values and the halo slots the received ones
        (`seaice_tpu/dynamics/evp.py:777-785`)."""
        loops = self._share(loops, solve)
        uv = solve["uv"]
        rows = torch.cat(exports)
        pending = self.comm.start(self.plans["vertex"], rows)
        evp_subcycle_step(*loops)
        full = self.comm.finish(pending)
        uv.index_copy_(1, self.uv_export_pos, rows.t())
        self._fill_uv_halo(uv, full)

    def make_step(self):
        """Build step(tensors, halo, state, forcing, atmos=None,
        ocean=None, coszen=None, day_of_year=None, lat=None, faero_atm=None,
        sfc_fluxes=None) -> (state, diags), each argument but day_of_year
        (one number for all blocks) a list with one entry per block of
        the rank: the step of `SeaIceModel` on every block, in lockstep,
        the velocity solve by the one-subcycle EVP kernel (a solver
        variant by its plain loop) with the vertex halo refreshed between
        subcycles (overlapped with the kernel under `overlap_enabled`).
        With the column package and `atmos` (AtmosForcing, OceanForcing,
        coszen and lat per block, as `scatter_cell_tree` makes them) each
        block runs the column phases on its own cells.  The config's
        optional conservation and monotonicity checks sum over a block and
        are left out, as in the JAX package.  Across ranks every rank
        calls the step together."""
        cfg = self.cfg
        check_kernel_options(cfg)
        remap_step = None
        if cfg.advection.advection_type == AdvectionType.INCREMENTAL_REMAP:
            # the departure-triangle search is sized by the global mesh's
            # vertex degree (a block's padding does not change it)
            remap_step = make_remap_step(
                self.tree, self.global_mesh.vertex_degree,
                monotonic=cfg.advection.monotonic)
        columns = [m.column for m in self.models]
        overlap = self.overlap or [None] * len(self.blocks)
        bodies = [dynamics_transport_steps(
            cfg, self.tree, evp.velocity_solve_steps(
                cfg, halo=True, min_dv_edge=self.part.min_dv_edge,
                overlap=ov),
            remap_step, adv_checks=False, column=col)
            for col, ov in zip(columns, overlap)]

        def step(tensors, halo, state, forcing, atmos=None, ocean=None,
                 coszen=None, day_of_year=None, lat=None, faero_atm=None,
                 sfc_fluxes=None):
            solve = {}          # the K6 loops of the solve under way

            def advance(kind, fields):
                if kind == "evp_subcycle":
                    with span("velocity.loop"):
                        self.evp_subcycle([f[0] for f in fields], solve)
                elif kind == "evp_overlap":
                    with span("velocity.loop"):
                        self.evp_overlap([f[0] for f in fields],
                                         [f[1] for f in fields], solve)
                else:
                    self.exchange(kind, fields, halo, solve)

            blocks = range(len(self.blocks))
            thermo = columns[0] is not None and atmos is not None
            with span("step"):
                if thermo:
                    none = [None] * len(self.blocks)
                    coszen, lat = coszen or none, lat or none
                    sfc_fluxes = sfc_fluxes or none
                    faero_atm = faero_atm or none
                    # every block's cells carry all their vertices, whose
                    # velocities the last exchange of the previous step
                    # refreshed, so a highfreq cell velocity is the owner's
                    pre = [column_before_dynamics(
                        cfg, columns[s], state[s], atmos[s], ocean[s],
                        coszen[s], day_of_year, lat[s], sfc_fluxes[s],
                        tensors[s].mesh, faero_atm[s]) for s in blocks]
                    state = [p[0] for p in pre]
                outs = drive_lockstep(
                    [body(t, st, f) for body, t, st, f in
                     zip(bodies, tensors, state, forcing)], advance)
                if thermo:
                    outs = [column_after_dynamics(
                        cfg, columns[s], *outs[s], atmos[s], pre[s][1])
                        for s in blocks]
            return [o[0] for o in outs], [o[1] for o in outs]

        return step


class GlobalView:
    """A ShardedSeaIceModel seen as one model of its whole mesh, for the
    analysis members (`analysis/`): `mesh`, `cfg`, `dtype`, `device`,
    `column` (every block's is the same per-cell physics) and `tensors`
    with the whole mesh's `area_cell` and `MeshTensors`."""

    def __init__(self, sm: ShardedSeaIceModel):
        self.mesh = sm.global_mesh
        self.cfg = sm.cfg
        self.dtype = sm.dtype
        self.device = sm.device
        self.column = sm.models[0].column
        self.tensors = _ViewTensors(
            mesh=self.mesh.tensors(sm.dtype, sm.device),
            area_cell=torch.as_tensor(np.ascontiguousarray(
                self.mesh.area_cell, np.float64)).to(
                    device=sm.device, dtype=sm.dtype))


@dataclasses.dataclass
class _ViewTensors:
    mesh: Any
    area_cell: Any


def full_physics_inputs(mesh, cfg, dtype=torch.float64, device=None):
    """Global initial state + forcing for a full-physics run: the port's
    copy of the JAX package's `parallel/sharded.py::full_physics_inputs`
    (its dryrun's and its sharding-invariance tests' inputs).

    Returns (area, vol, snow as numpy [nCells, nCat]; extra: the
    thermodynamic tracers as tensors; AtmosForcing, OceanForcing; coszen
    [nCells]), the tensors in dtype on device (None: the card)."""
    from ..column.driver import (AtmosForcing, OceanForcing,
                                 slab_ocean_frzmlt)
    from ..column.itd import category_boundaries
    from ..column.thermo_shared import (ice_enthalpy_from_temperature,
                                        melting_temperature,
                                        salinity_profile,
                                        snow_enthalpy_from_temperature)
    from ..testcases import box
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=dtype)

    ncat = cfg.run.n_categories
    ni = cfg.run.n_ice_layers
    ns = cfg.run.n_snow_layers
    nc = mesh.n_cells
    conc = np.clip(mesh.x_cell / box.BOX_LX, 0.05, 1.0)
    area = np.tile((conc / ncat)[:, None], (1, ncat)) * 0.9
    hmax = category_boundaries(ncat, cfg.column.kcatbound,
                               cfg.column.kitd)
    mids = 0.5 * (hmax[:-1] + np.minimum(hmax[1:], 10.0))
    vol = area * mids
    snow = area * 0.05
    S = salinity_profile(ni)
    has = t(area[..., None] > 0)
    sal = t(np.tile(S, (nc, ncat, 1)))
    extra = {
        "surfaceTemperature": t(np.where(area > 0, -12.0, 0.0)),
        "iceEnthalpy": ice_enthalpy_from_temperature(
            t(np.where(area[..., None] > 0, -8.0, 0.0) *
              np.ones((nc, ncat, ni))), melting_temperature(sal)) * has,
        "iceSalinity": sal * has,
        "snowEnthalpy": snow_enthalpy_from_temperature(
            t(-10.0 * np.ones((nc, ncat, ns)))) * has,
    }
    one = np.ones((nc,))
    dynf = box.box_forcing(mesh, t=0.0, dtype=torch.float64, device="cpu")
    atm = AtmosForcing(
        air_temperature=252.0 * one, specific_humidity=0.0004 * one,
        u_air=dynf.u_air_velocity.numpy(), v_air=dynf.v_air_velocity.numpy(),
        longwave_down=170.0 * one,
        sw_vis_dir=5.0 * one, sw_vis_dif=5.0 * one,
        sw_ir_dir=4.0 * one, sw_ir_dif=4.0 * one,
        rain_rate=0.0 * one, snow_rate=1e-5 * one,
        air_density=1.3 * one, air_level_height=10.0 * one)
    sst, Tf = -1.7 * one, -1.8 * one
    ocn = OceanForcing(
        sst=sst, sss=34.0 * one, freezing_temperature=Tf,
        frzmlt=slab_ocean_frzmlt(torch.as_tensor(sst), torch.as_tensor(Tf),
                                 torch.as_tensor(20.0 * one),
                                 cfg.run.dt).numpy(),
        mixed_layer_depth=20.0 * one)
    atm = AtmosForcing(**{f: t(getattr(atm, f))
                          for f in atm.__dataclass_fields__})
    ocn = OceanForcing(**{f: t(getattr(ocn, f))
                          for f in ocn.__dataclass_fields__})
    return area, vol, snow, extra, atm, ocn, t(0.5 * one)
