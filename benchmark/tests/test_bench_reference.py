"""The reference stands apart from the program and computes the
configuration's step: its sources import nothing of the program; its
geometry is exact where it can be checked by hand; and in float64 at a
small size it agrees with the program's plain path (the kernels' plain
versions on the CPU) far below the gaps the cell's limits allow."""

import ast
import os

import numpy as np
import pytest
import torch

from benchmark.harness.compare import (Mapping, field_gaps, flat_spec,
                                       numbers, to_numpy)
from benchmark.harness.manifest import BENCH_DIR, Cell
from benchmark.harness.sides import Side, reference_side
from benchmark.reference import sphere, transport

from .small import SMALL


def test_reference_imports_nothing_of_the_program():
    found = []
    d = os.path.join(BENCH_DIR, "reference")
    for n in os.listdir(d):
        if not n.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(d, n)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            found += [(n, m) for m in names
                      if m.split(".")[0].startswith("seaice_tpu")
                      or m.startswith("benchmark")]
    assert not found


def test_mesh_areas_cover_the_sphere():
    m = sphere.build(3)
    total = 4 * np.pi * m.radius ** 2
    assert m.area_cell.sum() == pytest.approx(total, rel=1e-12)
    assert m.area_triangle.sum() == pytest.approx(total, rel=1e-12)
    assert (m.n_corners == 5).sum() == 12


def square(x0=0.0):
    return (torch.tensor([[x0, 1.0, 1.0, x0]], dtype=torch.float64),
            torch.tensor([[0.0, 0.0, 1.0, 1.0]], dtype=torch.float64))


def test_clip_and_moments_of_a_square():
    px, py = square()
    one = torch.ones(1, dtype=torch.float64)
    zero = torch.zeros(1, dtype=torch.float64)
    # keep x <= 0.25: left of the upward line x = 0.25
    qx, qy = transport.clip(px, py, 0.25 * one, zero, 0.25 * one, one, one)
    M = transport.polygon_moments(qx, qy)[0]
    assert M[transport.MI[(0, 0)]] == pytest.approx(0.25)
    assert M[transport.MI[(1, 0)]] == pytest.approx(0.25 ** 2 / 2)
    assert M[transport.MI[(2, 1)]] == pytest.approx(0.25 ** 3 / 3 / 2)


def test_a_crossed_quadrilateral_counts_its_lobes_by_winding():
    """A bow-tie (0,0) (1,0) (0,1) (1,1): lobes of opposite sign."""
    px = torch.tensor([[0.0, 1.0, 0.0, 1.0]], dtype=torch.float64)
    py = torch.tensor([[0.0, 0.0, 1.0, 1.0]], dtype=torch.float64)
    M = transport.polygon_moments(px, py)[0]
    assert M[transport.MI[(0, 0)]] == pytest.approx(0.0, abs=1e-15)
    one = torch.ones(1, dtype=torch.float64)
    zero = torch.zeros(1, dtype=torch.float64)
    # the lower lobe alone: below the line y = 0.5 (right of it, -1)
    qx, qy = transport.clip(px, py, zero, 0.5 * one, one, 0.5 * one, -one)
    lobe = transport.polygon_moments(qx, qy)[0][transport.MI[(0, 0)]]
    assert abs(float(lobe)) == pytest.approx(0.25)


def test_reference_agrees_with_the_program_in_float64():
    cell = Cell("qu60_dycore.winter_caps")
    cell.apply({"config": {"mesh": {"subdivisions": 3},
                           "velocity": SMALL["config"]["velocity"]}})
    conf, traffic = cell.config, cell.traffic
    spec = cell.limits["amounts"]
    prog = Side(conf, traffic, 4242, "cpu", torch.float64)
    ref = reference_side(conf, traffic, 4242, "cpu")
    to_ref = Mapping(prog.mesh, ref.mesh)
    start = field_gaps(to_ref(to_numpy(prog.initial)), to_numpy(ref.state),
                       flat_spec(spec))
    assert max(v[0] for v in start.values()) == 0.0
    for _ in range(2):
        pre = to_ref(to_numpy(prog.snapshot()))
        prog.step()
        post = to_ref(to_numpy(prog.snapshot()))
        ref.load(pre)
        ref.step()
        got = numbers(post, to_numpy(ref.state), spec, pre)
        assert got["velocity.state_gap"][0] < 1e-4, got
        assert got["velocity.increment_gap"][0] < 1e-4, got
        assert got["ice.state_gap"][0] < 1e-8, got
        assert got["ice.increment_gap"][0] < 1e-3, got
