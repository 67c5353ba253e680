"""The program's spans in a traced window, and what the device did under
each.

The program marks where each span opens and closes with two empty ranges
in the trace, `seaice>name#k` and `seaice<name#k` (k: the instance number
of the `step` span; `seaice_tpu_torch/diagnostics.py`).  They lie among
the host's operations, on the clock of the device's.  `Spans` rebuilds
every span instance from them, pairs the runtime's launch, copy and set
calls with the device operations of the one stream in order, and gives
each device operation to the innermost span whose host interval holds
its launch.  Where the marks do not nest or the launch calls and the
device operations do not pair one to one, `Spans.ok` is False and every
reader built on it returns nothing; so it does where the program makes no
marks.  (A profiler session after the process's first loses a few device
records; the benchmark's traced window is its process's first.  Ops that
carry the profiler's correlation id pair by it instead, which survives a
lost record.)

Times are in the trace's microseconds; the readers report ms a step."""

from __future__ import annotations

import bisect
import re

PROGRAM = "seaice_tpu_torch"
OPEN, CLOSE = "seaice>", "seaice<"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
            "cudaMemsetAsync")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
_VERSION = re.compile(r"_v\d+$")
_MARK = re.compile(r"^seaice([<>])(.+)#(\d+)$")


def runtime_name(name: str) -> str:
    """A runtime call's name without CUPTI's version suffix."""
    return _VERSION.sub("", name)


def is_launch(name: str) -> bool:
    n = runtime_name(name)
    return n.startswith(LAUNCHES[:2]) or n in LAUNCHES[2:]


def is_sync(name: str) -> bool:
    return runtime_name(name) in SYNCS


class Span:
    __slots__ = ("name", "start", "end", "parent")

    def __init__(self, name, start, parent):
        self.name, self.start = name, start
        self.end, self.parent = None, parent     # parent: an index


def merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two lists of merged intervals."""
    return sum(by_label(a, [(s, e, 0) for s, e in b]).values())


def by_label(a, segments):
    """{label: length of the intersection of the merged intervals `a`
    with the segments (start, end, label) that carry it}; the segments
    sorted and disjoint."""
    out = {}
    i = j = 0
    while i < len(a) and j < len(segments):
        s, e, label = segments[j]
        lo, hi = max(a[i][0], s), min(a[i][1], e)
        if hi > lo:
            out[label] = out.get(label, 0.0) + hi - lo
        if a[i][1] < e:
            i += 1
        else:
            j += 1
    return out


def complement(intervals, lo, hi):
    """[lo, hi] less the merged intervals."""
    out, t = [], lo
    for s, e in intervals:
        if s > t:
            out.append([t, min(s, hi)])
        t = max(t, e)
    if t < hi:
        out.append([t, hi])
    return [iv for iv in out if iv[1] > iv[0]]


class Spans:
    def __init__(self, device_ops, host_ops):
        """device_ops, host_ops: (name, start, end) each, or (name, start,
        end, id) with the profiler's correlation id, which a runtime call
        shares with the device operation it made: then each device
        operation pairs with its own call, and a record the trace lost
        leaves the rest paired."""
        self.ok = False
        self.spans = []
        self.n_launches = self.n_device = 0
        self.unpaired = []      # (name, start) of device ops with no call
        self.launch_names = set()
        marks = sorted((op[1], op[2], op[0]) for op in host_ops
                       if op[0].startswith((OPEN, CLOSE)))
        if not marks or not self._build(marks):
            return
        device = sorted((op[1], op[2], op[0], op[3] if len(op) > 3 else None)
                        for op in device_ops)
        self.n_launches = sum(1 for op in host_ops if is_launch(op[0]))
        self.n_device = len(device)
        at = self._launch_times(device, host_ops)
        if at is None:
            return
        self.ok = True
        self.lo = min(min(op[1] for op in host_ops), device[0][0])
        self.hi = max(max(op[2] for op in host_ops),
                      max(d[1] for d in device))
        self.device = [d[:2] for d in device]
        self.owner = self._owners(at)
        self.syncs = sorted(op[1] for op in host_ops if is_sync(op[0]))
        self.busy = merged(self.device)
        self.idle = complement(self.busy, self.lo, self.hi)

    def _launch_times(self, device, host_ops):
        """The start of the call that made each device operation, or None
        where they do not pair.  By correlation id where the ops carry one
        and any pairs; else the launch calls in order, one to one."""
        if device and all(d[3] is not None for d in device) and \
                all(len(op) > 3 for op in host_ops):
            calls = {op[3]: (op[1], op[0]) for op in host_ops
                     if op[0].startswith("cu")}
            found = [calls.get(d[3]) for d in device]
            if any(f is not None for f in found):
                self.unpaired = [(d[2], d[0]) for d, f in zip(device, found)
                                 if f is None]
                self.launch_names = {runtime_name(f[1]) for f in found
                                     if f is not None}
                return None if self.unpaired else [f[0] for f in found]
        launches = sorted(op[1] for op in host_ops if is_launch(op[0]))
        if not launches or len(launches) != len(device):
            return None
        return launches

    def _build(self, marks) -> bool:
        """The span instances from the marks, well nested, or False."""
        stack = []
        for s, e, n in marks:
            m = _MARK.match(n)
            if m is None:
                return False
            kind, name = m.group(1), m.group(2)
            if kind == ">":
                self.spans.append(Span(name, s,
                                       stack[-1] if stack else None))
                stack.append(len(self.spans) - 1)
            else:
                if not stack or self.spans[stack[-1]].name != name:
                    return False
                self.spans[stack.pop()].end = e
        return not stack

    def segments(self):
        """The window cut where a span opens or closes: (start, end, index
        of the innermost span open there, or None)."""
        edges = sorted([(sp.start, True, i) for i, sp in
                        enumerate(self.spans)] +
                       [(sp.end, False, i) for i, sp in
                        enumerate(self.spans)],
                       key=lambda edge: edge[:2])
        out, stack, t = [], [], self.lo
        for when, opening, i in edges + [(self.hi, False, None)]:
            if when > t:
                out.append((t, when, stack[-1] if stack else None))
                t = when
            if i is None:
                break
            if opening:
                stack.append(i)
            else:
                stack.pop()
        return out

    def _owners(self, launches):
        """The innermost span instance (an index, or None) open at each
        launch."""
        segs = self.segments()
        starts = [s for s, _, _ in segs]
        return [segs[max(0, bisect.bisect_right(starts, t) - 1)][2]
                for t in launches]

    def within(self, i, name) -> bool:
        """Whether span instance i is, or lies inside, a `name` span."""
        while i is not None:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False

    def intervals(self, name):
        return merged((sp.start, sp.end) for sp in self.spans
                      if sp.name == name)

    def device_us(self, name) -> float:
        """Busy time of the device operations launched inside `name`."""
        inside = {}
        ops = [self.device[k] for k, i in enumerate(self.owner)
               if i is not None and inside.setdefault(
                   i, self.within(i, name))]
        return sum(e - s for s, e in merged(ops))

    def idle_inside_us(self, name) -> float:
        return overlap(self.idle, self.intervals(name))

    def idle_outside_us(self, name) -> float:
        return overlap(self.idle, complement(self.intervals(name), self.lo,
                                             self.hi))

    def idle_by_innermost(self):
        """{span name, or None outside every span: idle us while the host
        was in that span and in none inside it}."""
        out = {}
        for i, us in by_label(self.idle, self.segments()).items():
            name = self.spans[i].name if i is not None else None
            out[name] = out.get(name, 0.0) + us
        return out

    def device_by_innermost(self):
        """{span name, or None: busy us of the device operations whose
        launch lay in that span and in none inside it}."""
        by = {}
        for k, i in enumerate(self.owner):
            by.setdefault(self.spans[i].name if i is not None else None,
                          []).append(self.device[k])
        return {n: sum(e - s for s, e in merged(ops))
                for n, ops in by.items()}

    def syncs_inside(self, name) -> int:
        n = 0
        for s, e in self.intervals(name):
            n += bisect.bisect_right(self.syncs, e) - \
                bisect.bisect_left(self.syncs, s)
        return n


def of(ctx) -> Spans:
    """The spans of a reader's trace context, built once."""
    sp = getattr(ctx, "_program_spans", None)
    if sp is None:
        sp = ctx._program_spans = Spans(ctx.device_ops, ctx.host_ops)
    return sp


def setup_total(name):
    """A set-up span's total in seconds, from the program's recorder
    (set-up runs before the trace; every run builds its own model), or
    None where the program keeps no such span."""
    import importlib
    try:
        diag = importlib.import_module(f"{PROGRAM}.diagnostics")
    except ImportError:
        return None
    totals = getattr(getattr(diag, "RECORDER", None), "totals", None)
    return totals.get(name) if totals else None
