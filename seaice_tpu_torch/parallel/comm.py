"""Halo transport of the partitioned model: in one process, or across
processes under `torch.distributed`, one rank per card.

The JAX package runs the blocks as SPMD under `shard_map`, each halo
exchange a collective: an `all_gather` of every shard's export buffer, or
edge-coloured `ppermute` rounds (`seaice_tpu/parallel/sharded.py:58-134`).
The port's counterpart is one process per card: rank r of a group of W
holds the blocks [r k, (r+1) k) of the partition (k = n_shards / W) and
steps them in lockstep; a halo row that crosses ranks travels through the
process group.

`Comm` picks the transport once, from the group's backend
(`dist.get_backend`) and the model's device:

  "in-process"   no group: every block in this process; nothing is sent
                 (`ShardedSeaIceModel.exchange` runs the one-process
                 gather table);
  "nccl"         CUDA tensors, sent directly;
  "gloo"         CPU tensors, gloo's own;
  "gloo-staged"  CUDA tensors under gloo: packed on the card, copied to
                 pinned host buffers on a side stream, sent and received
                 by gloo on the host, copied back.  gloo's support for
                 CUDA tensors is partial (its send and receive may not take
                 them), so the port stages them itself.

One exchange of one kind of entity (cells or vertices) on a rank follows
a `HaloPlan`, built on the host from the one-process gather tables of
every block (`sharded.halo_gather_table`).  Every field of the exchange
goes into ONE packed export buffer [k nExport, F] (the fields as
columns), and the plan's table then gives each halo slot of the rank's
blocks a row of the "full" buffer:

  "allgather": full = [every rank's export buffer, gathered | one zero
    row]; the table is the one-process table, unchanged;
  "ring": the rank-neighbour graph edge-coloured into rounds
    (`color_halo_graph`); each exchange sends each peer rank ONE buffer
    (the export rows its blocks read, every field), all sends and
    receives issued in one `batch_isend_irecv` in the rounds' order, so
    their order cannot deadlock; full = [own export rows | the rows
    received, peer after peer | one zero row].

Both give every real halo slot the value of the one-process exchange,
bitwise (only copies move it); a padded slot takes entry (0, 0) under
"allgather" and zero under "ring", as in one process.

`start` begins an exchange and `finish` returns its full buffer, so that
a caller can compute between them (the interior/boundary overlap of the
velocity solve): NCCL's operations are asynchronous and `finish` makes
the current stream wait on them; the in-process and gloo-staged copies
run on a side CUDA stream ordered by events, and only gloo's host
transfer waits on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _bind_all_gather():
    """The one-tensor all-gather (output [W n, ...] from every rank's
    [n, ...]): torch 2.11 offers it as `all_gather_into_tensor` alone;
    torch 2.13 adds `all_gather_single` and marks the older name
    deprecated.  Bound once, at import, to the newer name where torch has
    it."""
    for name in ("all_gather_single", "all_gather_into_tensor"):
        if hasattr(dist, name):
            return getattr(dist, name)
    raise ImportError(
        "torch.distributed offers neither all_gather_single nor "
        "all_gather_into_tensor: the halo transport needs one of them")


_ALL_GATHER = _bind_all_gather()


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


def process_group(group=None):
    """The group a partitioned model spreads over: `group`, else the
    default group where one is initialised, else None (one process)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


@dataclasses.dataclass
class HaloPlan:
    """One kind's exchange on one rank (see the module docstring).
    n_rows: rows of the rank's export buffer (k nExport); table: [k,
    nHalo] rows of the full buffer, one row of it per local block;
    n_full: rows of the full buffer, its last row the zero row; gather:
    the "allgather" form.  Ring: send_rows [nSend] rows of the export
    buffer; p2p [(send, peer rank, first row, rows)] in the rounds'
    order, a send taking rows of the send buffer, a receive (send False)
    filling rows of the received part of the full buffer (which starts
    at n_rows)."""
    n_rows: int
    table: torch.Tensor
    n_full: int
    gather: bool
    send_rows: Optional[torch.Tensor] = None
    p2p: List[Tuple[bool, int, int, int]] = dataclasses.field(
        default_factory=list)
    rounds: int = 0

    @property
    def n_recv(self) -> int:
        return sum(n for send, _, _, n in self.p2p if not send)

    @property
    def n_send(self) -> int:
        return sum(n for send, _, _, n in self.p2p if send)


def build_halo_plan(mode: str, tables, n_export: int, rank: int,
                    world: int, device) -> HaloPlan:
    """The plan of one kind on `rank`.  tables: the one-process gather
    table of EVERY block (numpy, values in [0, S nExport], the last the
    zero entry), blocks [r k, (r+1) k) on rank r."""
    n_shards = len(tables)
    k = n_shards // world
    zero = n_shards * n_export
    mine = np.stack(tables[rank * k:(rank + 1) * k])     # [k, nHalo]

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(device)

    if mode == "allgather":
        return HaloPlan(n_rows=k * n_export, table=ix(mine),
                        n_full=zero + 1, gather=True)
    if mode != "ring":
        raise ValueError(f"halo_mode {mode!r}: 'ring' or 'allgather'")

    def rows_read(dst, src):
        """Sorted export rows (global numbering) of rank src's blocks
        that rank dst's blocks read."""
        t = np.concatenate(tables[dst * k:(dst + 1) * k])
        t = t[t < zero]
        return np.unique(t[t // (k * n_export) == src])

    edges = {(src, dst) for dst in range(world) for src in range(world)
             if src != dst and len(rows_read(dst, src))}
    perms, _ = color_halo_graph(edges, world)
    base = rank * k * n_export
    send_rows, p2p, recv_lists = [], [], {}
    n_sent = n_recv = 0
    for perm in perms:
        for src, dst in perm:
            if src == rank:
                rows = rows_read(dst, rank) - base
                p2p.append((True, dst, n_sent, len(rows)))
                send_rows.append(rows)
                n_sent += len(rows)
            elif dst == rank:
                rows = rows_read(rank, src)
                p2p.append((False, src, n_recv, len(rows)))
                recv_lists[src] = (n_recv, rows)
                n_recv += len(rows)
    n_rows = k * n_export
    table = np.full(mine.shape, n_rows + n_recv, np.int64)
    own = (mine < zero) & (mine // (k * n_export) == rank)
    table[own] = mine[own] - base
    for src, (first, rows) in recv_lists.items():
        sel = (mine < zero) & (mine // (k * n_export) == src)
        table[sel] = n_rows + first + np.searchsorted(rows, mine[sel])
    return HaloPlan(
        n_rows=n_rows, table=ix(table), n_full=n_rows + n_recv + 1,
        gather=False,
        send_rows=ix(np.concatenate(send_rows) if send_rows
                     else np.zeros(0, np.int64)),
        p2p=p2p, rounds=len(perms))


@dataclasses.dataclass
class _Pending:
    plan: HaloPlan
    exports: torch.Tensor
    full: torch.Tensor
    works: list
    event: Optional[torch.cuda.Event] = None
    host: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class Comm:
    """The transport of one partitioned model on this rank: `route`
    ("in-process", "nccl", "gloo" or "gloo-staged"), `rank`,
    `world_size`; the halo exchange (`start`, `finish`), the collectives
    the gathers and the abort gate use (`all_gather`, `all_reduce_max`)
    and `barrier`.  `bytes_staged` counts the bytes the gloo-staged
    route copied between the card and the host."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if group is None:
            self.route, self.rank, self.world_size = "in-process", 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)
            backend = str(dist.get_backend(group))
            if backend == "nccl":
                if not cuda:
                    raise ValueError(
                        f"an NCCL group carries CUDA tensors; the model's "
                        f"device is {self.device}")
                self.route = "nccl"
            elif backend == "gloo":
                self.route = "gloo-staged" if cuda else "gloo"
            else:
                raise ValueError(
                    f"process-group backend {backend!r}: the halo "
                    "transport takes 'nccl' or 'gloo'")
        self._side = None          # the side CUDA stream, made at first use
        self._pinned = {}          # the gloo-staged route's host buffers
        self.bytes_staged = 0

    # -- collectives --------------------------------------------------------

    def barrier(self):
        if self.route == "nccl":
            dist.barrier(self.group, device_ids=[self.device.index])
        elif self.route != "in-process":
            dist.barrier(self.group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t [n, ...] (the same shape on every rank), rank
        after rank: [world * n, ...] on t's device."""
        if self.route == "in-process":
            return t
        t = t.contiguous()
        out = torch.empty((self.world_size * t.shape[0],) + t.shape[1:],
                          dtype=t.dtype, device=t.device)
        if self.route == "gloo-staged":
            host = torch.empty(out.shape, dtype=t.dtype)
            _ALL_GATHER(host, t.cpu(), group=self.group)
            self.bytes_staged += (t.numel() + host.numel()) * t.element_size()
            return out.copy_(host)
        _ALL_GATHER(out, t, group=self.group)
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of t over the ranks (a new tensor); a
        collective of a group (`world_size > 1`)."""
        if self.route == "gloo-staged":
            host = t.cpu()
            dist.all_reduce(host, op=dist.ReduceOp.MAX, group=self.group)
            return host.to(t.device)
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    # -- halo exchange ------------------------------------------------------

    def exchange(self, plan: HaloPlan, exports: torch.Tensor) -> torch.Tensor:
        """The full buffer of one exchange, waited for."""
        return self.finish(self.start(plan, exports))

    def start(self, plan: HaloPlan, exports: torch.Tensor) -> _Pending:
        """Begin the exchange of the rank's packed export buffer
        [plan.n_rows, F] (contiguous, on the model's device)."""
        if tuple(exports.shape[:1]) != (plan.n_rows,) or exports.ndim != 2:
            raise ValueError(f"export buffer {tuple(exports.shape)}: "
                             f"expected ({plan.n_rows}, F)")
        exports = exports.contiguous()
        full = torch.empty((plan.n_full, exports.shape[1]),
                           dtype=exports.dtype, device=exports.device)
        p = _Pending(plan, exports, full, [])
        route = self.route
        if route == "in-process":
            # one rank: the full buffer is the export buffer and the zero
            # row, copied on the side stream
            with self._side_stream(p):
                full[:plan.n_rows].copy_(exports)
                full[-1].zero_()
            return p
        full[-1].zero_()
        if not plan.gather:
            full[:plan.n_rows].copy_(exports)
        if route == "gloo-staged":
            send = exports if plan.gather else \
                exports.index_select(0, plan.send_rows)
            n_in = (full.shape[0] - 1) if plan.gather else plan.n_recv
            host_send = self._pinned_buffer("send", send.shape, send.dtype)
            host_recv = self._pinned_buffer(
                "recv", (n_in,) + tuple(send.shape[1:]), send.dtype)
            with self._side_stream(p):
                host_send.copy_(send, non_blocking=True)
            p.host = (host_send, host_recv)
            p.exports = send           # kept alive until the copy is done
            return p
        # NCCL (CUDA tensors) and gloo (CPU tensors): asynchronous ops
        if plan.gather:
            p.works = [_ALL_GATHER(full[:-1], exports, group=self.group,
                                   async_op=True)]
        else:
            send = exports.index_select(0, plan.send_rows)
            p.exports = send
            p.works = self._p2p(plan, send, full[plan.n_rows:-1])
        return p

    def finish(self, p: _Pending) -> torch.Tensor:
        """The full buffer [plan.n_full, F] of an exchange begun by
        `start`, ready for the current stream."""
        plan, full = p.plan, p.full
        if self.route == "gloo-staged":
            host_send, host_recv = p.host
            p.event.synchronize()      # the packed rows are on the host
            if plan.gather:
                _ALL_GATHER(host_recv, host_send, group=self.group)
                dst = full[:-1]
            else:
                for w in self._p2p(plan, host_send, host_recv):
                    w.wait()
                dst = full[plan.n_rows:-1]
            self.bytes_staged += ((host_send.numel() + host_recv.numel()) *
                                  host_send.element_size())
            with self._side_stream(p):
                dst.copy_(host_recv, non_blocking=True)
        for w in p.works:
            w.wait()
        if p.event is not None:
            torch.cuda.current_stream(full.device).wait_event(p.event)
        return full

    def _p2p(self, plan: HaloPlan, send, recv):
        """The ring's sends and receives, in the rounds' order, issued in
        one `batch_isend_irecv`."""
        ops = [dist.P2POp(dist.isend if out else dist.irecv,
                          (send if out else recv)[first:first + n],
                          dist.get_global_rank(self.group, peer), self.group)
               for out, peer, first, n in plan.p2p]
        return dist.batch_isend_irecv(ops) if ops else []

    def _pinned_buffer(self, which, shape, dtype):
        key = (which, tuple(shape), dtype)
        if key not in self._pinned:
            self._pinned[key] = torch.empty(shape, dtype=dtype,
                                            pin_memory=True)
        return self._pinned[key]

    @contextlib.contextmanager
    def _side_stream(self, p: _Pending):
        """CUDA work in the block runs on the side stream after the
        current stream's work so far, `p.event` recorded at its end; on
        the CPU the work runs in place."""
        if self.device.type != "cuda":
            yield
            return
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            yield
        p.event = torch.cuda.Event()
        p.event.record(self._side)
