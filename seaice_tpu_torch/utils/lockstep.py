"""Steps written as generators that stop at every halo exchange.

A step of a partitioned mesh needs its halo entries refreshed from the
blocks that own them at fixed points inside the step (the EVP masks, the
velocities before and after every elastic subcycle, the tracers after
transport).  The JAX package runs the blocks as SPMD and does each
exchange as a collective inside the per-block body.  Here the per-block
body is a Python generator: at each exchange point it yields
`(kind, fields)`, a kind from `KINDS` and a tuple of tensors that it owns
(nothing else refers to them), and continues once their halo entries have
been refreshed IN PLACE.

`drive` runs one generator (one block, or an unpartitioned mesh) to its
end; `drive_lockstep` runs one generator per block, advancing all of them
to the same exchange point before each exchange.  All blocks issue their
work onto one stream in a fixed order, so runs repeat bitwise; stream
order puts every exchange after the launches that feed it, so nothing
synchronises.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

# "cell_field": cell fields [nCells, ...];  "vertex_field": vertex fields
# [nVertices];  "vertex_uv": the velocity pair (u, v), [nVertices] each
KINDS = ("cell_field", "vertex_field", "vertex_uv")


def drive(gen, exchanges: Optional[Dict[str, Callable]] = None):
    """Run a step generator to its end and return its value.

    exchanges: optional {kind: fn}.  "cell_field" and "vertex_field" take
    one field, "vertex_uv" takes (u, v); each returns the refreshed
    field(s).  A returned tensor that is not the one handed over is copied
    into it, so both functional and in-place exchanges work.  A kind
    without a function (or exchanges=None) is the identity: one block."""
    try:
        kind, fields = gen.send(None)
        while True:
            fn = exchanges.get(kind) if exchanges else None
            if fn is not None:
                if kind == "vertex_uv":
                    new = fn(*fields)
                else:
                    new = tuple(fn(f) for f in fields)
                for f, n in zip(fields, new):
                    if n is not f:
                        f.copy_(n)
            kind, fields = gen.send(None)
    except StopIteration as stop:
        return stop.value


def drive_lockstep(gens: List, exchange: Callable):
    """Run one step generator per block in lockstep; returns the list of
    their values.

    exchange(kind, fields_per_block) refreshes the halo entries of every
    block's fields in place; fields_per_block[s] is the tuple block s
    yielded.  Every block must reach the same exchange points in the same
    order."""
    n = len(gens)
    out = [None] * n
    while True:
        reqs, done = [], []
        for s in range(n):
            try:
                reqs.append(gens[s].send(None))
            except StopIteration as stop:
                out[s] = stop.value
                done.append(s)
        if done:
            if len(done) != n:
                raise RuntimeError(
                    f"blocks {done} finished their step while the others "
                    "wait at an exchange")
            return out
        kinds = {kind for kind, _ in reqs}
        if len(kinds) != 1:
            raise RuntimeError(f"blocks out of step: exchanges {kinds}")
        exchange(kinds.pop(), [fields for _, fields in reqs])
