"""Partitioned sea-ice model: the mesh split into blocks, stepped in one
process.

The port of the JAX package's `parallel/sharded.py`, the replacement for
the reference's MPI block loop + dmpar halo exchange.  Each block runs the
single-block step on its local mesh (owned + 2-deep halo, the MPAS block
structure; `partition.py`), and the halos are refreshed inside the step:

  per elastic subcycle: the vertex-velocity halo (the reference exchanges
    uVelocity/vVelocity once per subcycle,
    mpas_seaice_velocity_solver.F:2546-2584), between calls of the
    one-subcycle EVP kernel `evp_subcycle_step`, one call for every block
    of the card (`evp_subcycle`);
  before the loop: the solveStress / solveVelocity masks and (u, v);
  per dynamics subcycle: the 2-deep cell halo of every tracer after
    transport (reference ...incremental_remap.F:2429-2487).

The JAX package runs the blocks as SPMD under `shard_map`, each exchange a
collective inside the per-block body.  Here the per-block body is a
generator that stops at each exchange (`utils/lockstep.py`); the step
advances every block to the same exchange point, refreshes the halos in
place, and resumes them, all on one stream.

An exchange gathers each block's export buffer (its owned entities that
other blocks need) and fills every halo slot from the concatenation of
those buffers, through a table fixed when the model is built:

  "allgather": slot <- buffers[src_shard][src_idx], every block shipping
    its exports to all; a padded halo slot (global id -1) takes entry
    (0, 0), as the JAX package's `_gather_halo` gives it;
  "ring": the block-neighbour graph edge-coloured into rounds of
    (src, dst) copies (`color_halo_graph`); in round ci block dst takes
    src's buffer at its halo slots of colour ci.  In one process a round's
    copy is a reference, so the rounds are resolved into the table; padded
    slots (colour -1) stay zero, as `_perm_halo` leaves them.

Both give every real halo slot the same value, bitwise.  All blocks live
on one device: several devices (peer copies or NCCL) and `overlap=True`
raise NotImplementedError (ROADMAP Queue 1 item 10).

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
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import AdvectionType, Config
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
from .partition import partition_mesh

_LATER = "ROADMAP Queue 1 item 10"


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


def color_halo_graph(edges, n_shards):
    """Decompose the shard-neighbor digraph into partial permutations.

    edges: set of (src_shard, dst_shard) pairs meaning 'dst needs halo
    data owned by src'. Greedy bipartite edge coloring: each color
    class uses every shard at most once as a source and once as a
    target, so it is a valid round of point-to-point copies. The number
    of colors is bounded by ~2x the max shard neighbor degree — a
    topology constant, independent of the shard count (a 2-D Morton
    block touches O(1) neighbor blocks however many shards there are).

    Returns (perms, color_of): perms[c] = [(src, dst), ...];
    color_of[(src, dst)] = c."""
    perms = []
    src_used = []    # per color: sets of used sources / targets
    dst_used = []
    color_of = {}
    # deterministic order; long edges first makes greedy tighter
    for (r, s) in sorted(edges):
        for ci in range(len(perms) + 1):
            if ci == len(perms):
                perms.append([])
                src_used.append(set())
                dst_used.append(set())
            if r not in src_used[ci] and s not in dst_used[ci]:
                perms[ci].append((r, s))
                src_used[ci].add(r)
                dst_used[ci].add(s)
                color_of[(r, s)] = ci
                break
    return [tuple(p) for p in perms], color_of


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


class ShardedSeaIceModel:
    """The model on a partitioned mesh: same Config and semantics as
    SeaIceModel; tensors, halo maps, states and forcings are lists with
    one entry per block (the JAX package stacks them on a shard axis)."""

    def __init__(self, mesh: Mesh, cfg: Config, n_shards: int,
                 dtype=torch.float32, devices=None,
                 halo_mode: str = "ring", overlap: bool = False,
                 tracer_tree=None):
        """devices: None (every block on the GPU, or an error without
        one), one device, or a list of devices that names one device.
        halo_mode: "ring" (rounds of neighbour copies, default) or
        "allgather".  tracer_tree: as `SeaIceModel` takes it."""
        if overlap:
            raise NotImplementedError(
                "overlap=True: the interior/boundary overlap of the halo "
                "exchange needs the exchange on its own CUDA stream; in "
                f"one process on one stream nothing overlaps; {_LATER}")
        if isinstance(devices, (list, tuple)):
            names = {resolve_device(d) for d in devices}
            if len(names) != 1:
                raise NotImplementedError(
                    f"blocks on {len(names)} devices: peer copies or NCCL "
                    f"between cards are not ported; {_LATER}")
            devices = names.pop()
        self.device = resolve_device(devices)
        self.global_mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.halo_mode = halo_mode
        self.part = partition_mesh(mesh, n_shards)
        self.n_shards = n_shards
        self.models = [SeaIceModel(b.mesh, cfg, dtype, device=self.device,
                                   tracer_tree=tracer_tree)
                       for b in self.part.blocks]
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

        self.halo = []
        for s, b in enumerate(self.part.blocks):
            cv, vv = halo_valid(b)
            v_col = colors(b.vertex_halo_src_shard, vv, s)
            c_col = colors(b.cell_halo_src_shard, cv, s)
            self.halo.append(HaloMaps(
                vertex_export_idx=ix(b.vertex_export_idx),
                vertex_halo_src_shard=ix(b.vertex_halo_src_shard),
                vertex_halo_src_idx=ix(b.vertex_halo_src_idx),
                cell_export_idx=ix(b.cell_export_idx),
                cell_halo_src_shard=ix(b.cell_halo_src_shard),
                cell_halo_src_idx=ix(b.cell_halo_src_idx),
                vertex_owned_mask=fl(b.vertex_owned_mask),
                cell_owned_mask=fl(b.cell_owned_mask),
                vertex_halo_color=ix(v_col), cell_halo_color=ix(c_col),
                vertex_halo_gather=ix(halo_gather_table(
                    halo_mode, s, b.vertex_halo_src_shard,
                    b.vertex_halo_src_idx, v_col, self.halo_perms,
                    len(b.vertex_export_idx), n_shards)),
                cell_halo_gather=ix(halo_gather_table(
                    halo_mode, s, b.cell_halo_src_shard,
                    b.cell_halo_src_idx, c_col, self.halo_perms,
                    len(b.cell_export_idx), n_shards))))
        self.n_vertices_owned = self.part.blocks[0].n_vertices_owned
        self.n_cells_owned = self.part.blocks[0].n_cells_owned
        # the vertex halo of every block as one gather and one scatter on
        # the K6 loops' shared velocity buffer [2, B*nv + 1]
        # (`evp_subcycle_share_uv`): the same tables composed with the
        # export lists, the zero entry of the ring at B*nv
        nv = self.part.blocks[0].mesh.n_vertices
        if any(b.mesh.n_vertices != nv for b in self.part.blocks):
            raise ValueError("blocks of unequal vertex counts")
        exp = np.stack([b.vertex_export_idx for b in self.part.blocks])
        n_exp = exp.shape[1]
        src, dst = [], []
        for s, h in enumerate(self.halo):
            t = h.vertex_halo_gather.cpu().numpy()
            r, j = np.divmod(np.minimum(t, n_shards * n_exp - 1), n_exp)
            src.append(np.where(t == n_shards * n_exp, n_shards * nv,
                                r * nv + exp[r, j]))
            dst.append(s * nv + self.n_vertices_owned + np.arange(len(t)))
        self.uv_halo_src = ix(np.concatenate(src))
        self.uv_halo_dst = ix(np.concatenate(dst))

    # -- state scatter/gather ------------------------------------------------

    def init_state(self, ice_area_cat=None, ice_volume_cat=None,
                   snow_volume_cat=None) -> List[State]:
        def sc(f):
            if f is None:
                return [None] * self.n_shards
            return self.part.scatter_cell_field(np.asarray(f))

        return [m.init_state(a, v, sn) for m, a, v, sn in zip(
            self.models, sc(ice_area_cat), sc(ice_volume_cat),
            sc(snow_volume_cat))]

    def scatter_forcing(self, forcing_fn):
        """forcing_fn(local_mesh) -> DynamicsForcing; one per block."""
        return [forcing_fn(b.mesh) for b in self.part.blocks]

    def scatter_cell_tree(self, tree):
        """A container of global [nCells, ...] fields (an array, a tensor,
        a dict, or a dataclass such as DynamicsForcing) -> one container
        per block, on the blocks' device; floating fields in the model's
        dtype."""
        if tree is None:
            return [None] * self.n_shards
        if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
            parts = {f.name: self.scatter_cell_tree(getattr(tree, f.name))
                     for f in dataclasses.fields(tree)}
            return [dataclasses.replace(tree, **{k: p[s]
                                                 for k, p in parts.items()})
                    for s in range(self.n_shards)]
        if isinstance(tree, dict):
            parts = {k: self.scatter_cell_tree(v) for k, v in tree.items()}
            return [{k: p[s] for k, p in parts.items()}
                    for s in range(self.n_shards)]
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        local = self.part.scatter_cell_field(np.asarray(tree))
        out = [torch.as_tensor(a).to(self.device) for a in local]
        return [t.to(self.dtype) if t.is_floating_point() else t
                for t in out]

    def gather_tracers(self, states: List[State]) -> Dict[str, np.ndarray]:
        return {name: self.part.gather_cell_field(
                    np.stack([st.tracers[name].detach().cpu().numpy()
                              for st in states]), self.global_mesh.n_cells)
                for name in states[0].tracers}

    def gather_velocity(self, states: List[State]):
        def g(name):
            return self.part.gather_vertex_field(
                np.stack([getattr(st.velocity, name).detach().cpu().numpy()
                          for st in states]), self.global_mesh.n_vertices)
        return g("u_velocity"), g("v_velocity")

    # -- halo exchange and step ---------------------------------------------

    def exchange(self, kind: str, fields_per_block, halo=None, solve=None):
        """Refresh, in place, the halo entries of every block's fields:
        fields_per_block[s] is a tuple of block s's cell fields
        (kind "cell_field") or vertex fields ("vertex_field",
        "vertex_uv"), each [nLocal, ...].  halo: the blocks' HaloMaps
        (default: the model's).  solve: the velocity solve under way
        (`evp_subcycle`); where the fields are its loops' velocities, held
        in one buffer, the exchange is one gather and one scatter."""
        halo = self.halo if halo is None else halo
        if kind == "vertex_uv" and solve and halo is self.halo and all(
                f[0] is lp.u and f[1] is lp.v
                for f, lp in zip(fields_per_block, solve["loops"])):
            uv = solve["uv"]
            uv.index_copy_(1, self.uv_halo_dst,
                           uv.index_select(1, self.uv_halo_src))
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

    def evp_subcycle(self, loops, solve=None):
        """One elastic subcycle of every block's velocity solve: the K6
        loops of the blocks on the card, in block order, in one call.
        solve: a dict for the solve under way; at its first subcycle the
        loops' velocities move into one buffer (`evp_subcycle_share_uv`),
        which `exchange` then refreshes in two operations."""
        loops = tuple(loops)
        if solve is not None and solve.get("loops") != loops:
            solve["loops"], solve["uv"] = loops, evp_subcycle_share_uv(loops)
        evp_subcycle_step(*loops)

    def make_step(self):
        """Build step(tensors, halo, state, forcing, atmos=None,
        ocean=None, coszen=None) -> (state, diags), each argument a list
        with one entry per block: the step of `SeaIceModel` on every
        block, in lockstep, the velocity solve by the one-subcycle EVP
        kernel with the vertex halo refreshed between subcycles.  With
        the column package and `atmos` (AtmosForcing, OceanForcing and
        coszen per block, as `scatter_cell_tree` makes them) each block
        runs the column phases on its own cells.  The config's optional
        conservation and monotonicity checks sum over a block and are
        left out, as in the JAX package."""
        cfg = self.cfg
        check_kernel_options(cfg)
        vel_solve = evp.velocity_solve_steps(cfg, halo=True)
        remap_step = None
        if cfg.advection.advection_type == AdvectionType.INCREMENTAL_REMAP:
            # the departure-triangle search is sized by the global mesh's
            # vertex degree (a block's padding does not change it)
            remap_step = make_remap_step(
                self.tree, self.global_mesh.vertex_degree,
                monotonic=cfg.advection.monotonic)
        columns = [m.column for m in self.models]
        bodies = [dynamics_transport_steps(cfg, self.tree, vel_solve,
                                           remap_step, adv_checks=False,
                                           column=col) for col in columns]

        def step(tensors, halo, state, forcing, atmos=None, ocean=None,
                 coszen=None):
            solve = {}          # the K6 loops of the solve under way

            def advance(kind, fields):
                if kind == "evp_subcycle":
                    self.evp_subcycle([f[0] for f in fields], solve)
                else:
                    self.exchange(kind, fields, halo, solve)

            blocks = range(self.n_shards)
            thermo = columns[0] is not None and atmos is not None
            if thermo:
                coszen = coszen or [None] * self.n_shards
                pre = [column_before_dynamics(cfg, columns[s], state[s],
                                              atmos[s], ocean[s], coszen[s])
                       for s in blocks]
                state = [p[0] for p in pre]
            outs = drive_lockstep(
                [body(t, st, f) for body, t, st, f in
                 zip(bodies, tensors, state, forcing)], advance)
            if thermo:
                outs = [column_after_dynamics(cfg, columns[s], *outs[s],
                                              atmos[s], pre[s][1])
                        for s in blocks]
            return [o[0] for o in outs], [o[1] for o in outs]

        return step


def full_physics_inputs(mesh, cfg, dtype=torch.float64, device="cpu"):
    """Global initial state + forcing for a full-physics run: the port's
    copy of the JAX package's `parallel/sharded.py::full_physics_inputs`
    (its dryrun's and its sharding-invariance tests' inputs).

    Returns (area, vol, snow as numpy [nCells, nCat]; extra: the
    thermodynamic tracers as tensors; AtmosForcing, OceanForcing; coszen
    [nCells]), the tensors in dtype on device."""
    from ..column.driver import (AtmosForcing, OceanForcing,
                                 slab_ocean_frzmlt)
    from ..column.itd import category_boundaries
    from ..column.thermo_shared import (ice_enthalpy_from_temperature,
                                        melting_temperature,
                                        salinity_profile,
                                        snow_enthalpy_from_temperature)
    from ..testcases import box

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
