"""Faults planted in the program's step for the benchmark's tests, each
installed on the program's `Side` once it is built (`cli.main(fault=)`):
the step returning its state unchanged, half of the cells left
unstepped, one answer (the ice volume) altered where the step produces
it, and the velocity solve alone broken (its loop ended after half of its
elastic subcycles)."""

import numpy as np

from benchmark.harness.compare import to_numpy


def unchanged(side):
    side.step = lambda: None


def _after(side, change):
    orig = side.step

    def step():
        pre = to_numpy(side.snapshot())
        orig()
        side.load(change(pre, to_numpy(side.snapshot())))

    side.step = step


def half_cells(side):
    n = (side.mesh.n_cells, side.mesh.n_vertices)

    def change(pre, post):
        out = dict(post)
        for k, b in post.items():
            if np.ndim(b) and np.shape(b)[0] in n:
                c = np.array(b, copy=True)
                keep = np.arange(len(c)) % 2 == 0
                c[keep] = pre[k][keep]
                out[k] = c
        return out

    _after(side, change)


def altered(side):
    def change(pre, post):
        out = dict(post)
        out["tracers.iceVolumeCategory"] = \
            post["tracers.iceVolumeCategory"] * 1.01
        return out

    _after(side, change)


def loop_cut_short(side):
    from benchmark.harness.sides import velocity_loop_cut_short
    orig = side.step

    def step():
        with velocity_loop_cut_short():
            orig()

    side.step = step
