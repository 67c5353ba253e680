"""What the per-layer readers read: the traced window's device operations
and spans, reduced once, with the cell's sizes beside them.

Device operations are the profiler's CUDA events (kernels, copies, sets);
busy time is the union of their intervals.  An idle gap is a stretch of
the window in which no device operation ran; it is named by what the
host was doing at its start: the innermost host operation (an aten call,
a synchronise)."""

from __future__ import annotations

import numpy as np

US = 1e-6


def merged(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceContext:
    def __init__(self, window, conf, mesh_sizes, extra):
        tr = window.trace
        self.steps = window.steps
        self.window_s = window.window_s
        self.conf = conf
        self.mesh = mesh_sizes
        self.extra = extra
        self.device_ops = tr["device_ops"]
        self.host_ops = tr["host_ops"]
        self.flux_calls = tr["flux_calls"]
        self.busy = merged((s, e) for _, s, e in self.device_ops)
        self.busy_s = sum(e - s for s, e in self.busy) * US

    def kernels(self, fragment: str):
        """Durations (s) of the device operations whose name holds
        `fragment`."""
        return [(e - s) * US for n, s, e in self.device_ops
                if fragment in n]

    def n_kernels(self) -> int:
        return sum(1 for n, _, _ in self.device_ops
                   if not n.startswith(("Memcpy", "Memset")))

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing."""
        by = {}
        for n, s, e in self.device_ops:
            by[n] = by.get(n, 0.0) + (e - s) * US
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for (s0, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            gaps.append((s1 - e0, e0))
        gaps.sort(reverse=True)
        named = []
        for length, at in gaps[:top]:
            inner = [(e - s, n) for n, s, e in self.host_ops if s <= at < e]
            op = min(inner)[1] if inner else "no host operation"
            named.append([op[:120], length * US])
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": named}


def percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))
