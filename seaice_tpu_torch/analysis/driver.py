"""Analysis driver: iterate registered members, dispatching their
bootstrap/init/precompute/compute/write hooks on per-member alarms
(reference mpas_seaice_analysis_driver.F: member list :150-168, hook
dispatch :410-560).

A member computes on the device: its `results` hold tensors (and host
numbers), fetched to the host in one copy per dtype when it writes
(`utils.containers.to_host`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..forcing.clock import Alarm, ModelClock
from ..utils.containers import to_host


class AnalysisMember:
    """Base class; members override the hooks they need (the reference's
    function-pointer table)."""

    name = "template"
    # the keys of the step's diagnostics dict that `compute` reads
    diag_keys: Tuple[str, ...] = ()

    def __init__(self, compute_interval: float = 86400.0,
                 write_interval: Optional[float] = None):
        self.compute_alarm = Alarm(compute_interval)
        self.write_alarm = Alarm(write_interval or compute_interval)
        self.results: Dict[str, Any] = {}
        self.last_diags: Optional[Dict[str, Any]] = None

    @property
    def precomputes(self) -> bool:
        """Whether this member's precompute does anything (it then runs
        every step)."""
        return type(self).precompute is not AnalysisMember.precompute

    # hooks (reference :43-52)
    def bootstrap(self, model, state):
        pass

    def init(self, model, state):
        pass

    def precompute(self, model, state, clock: ModelClock):
        pass

    def compute(self, model, state, clock: ModelClock) -> Dict[str, Any]:
        return {}

    def write(self, stream, clock: ModelClock):
        if stream is not None and self.results:
            numeric = {k: v for k, v in to_host(self.results).items()
                       if hasattr(v, "shape") or isinstance(
                           v, (int, float, np.number))}
            if numeric:
                stream.write(numeric, clock.timestamp())


class AnalysisDriver:
    """Owns the member list; called from the run loop each step."""

    def __init__(self, members: List[AnalysisMember], stream=None):
        self.members = members
        self.stream = stream

    def bootstrap(self, model, state):
        for m in self.members:
            m.bootstrap(model, state)

    def init(self, model, state):
        for m in self.members:
            m.init(model, state)

    def on_timestep(self, model, state, clock: ModelClock,
                    diags: Optional[Dict[str, Any]] = None,
                    write: bool = True):
        """precompute -> compute -> write, alarm-gated per member
        (reference timeLoop integration :321-331).  state: the state, or
        a function that returns it; diags: the step's diagnostics dict,
        or a function of the keys wanted that returns it.  A function is
        called once, and only in a step where a member precomputes or
        computes (the sharded runner gathers the blocks so).  Each member
        that computes finds the keys it names in `diag_keys` in
        `last_diags`.  write=False leaves the members' writes out (the
        ranks of a partitioned run other than rank 0)."""
        due = [(m, m.compute_alarm.is_ringing(clock),
                m.write_alarm.is_ringing(clock)) for m in self.members]
        busy = [m for m, compute, _ in due if compute or m.precomputes]
        if busy:
            if callable(state):
                state = state()
            if callable(diags):
                diags = diags(sorted({k for m in busy for k in m.diag_keys}))
        for m, compute, due_write in due:
            if m in busy:
                m.last_diags = {k: diags[k] for k in m.diag_keys
                                if k in diags} if diags else {}
                m.precompute(model, state, clock)
                if compute:
                    m.results = m.compute(model, state, clock) or {}
            if write and due_write:
                m.write(self.stream, clock)

    def result(self, member_name: str) -> Dict[str, Any]:
        for m in self.members:
            if m.name == member_name:
                return m.results
        raise KeyError(member_name)
