"""The port's mesh partition (`seaice_tpu_torch/parallel/partition.py`)
and its halo rounds against the JAX package's, bitwise: the same mesh,
built by each package's own generator, split by each package's own
`partition_mesh`."""

import numpy as np
import pytest

import seaice_tpu.mesh as jmesh
import seaice_tpu_torch.mesh as tmesh
from seaice_tpu.parallel.partition import partition_mesh as jpartition
from seaice_tpu.parallel.sharded import color_halo_graph as jcolor
from seaice_tpu.testcases import box as jbox
from seaice_tpu_torch.parallel.partition import partition_mesh as tpartition
from seaice_tpu_torch.parallel.sharded import (color_halo_graph as tcolor,
                                               halo_gather_table)
from seaice_tpu_torch.testcases import box as tbox

CASES = {
    "box12-2": (lambda p: (jbox if p == "j" else tbox).box_test_mesh(12, 12),
                2),
    "box12-4": (lambda p: (jbox if p == "j" else tbox).box_test_mesh(12, 12),
                4),
    "icos2-4": (lambda p: (jmesh if p == "j" else tmesh).icosahedral_mesh(2),
                4),
}

BLOCK_ARRAYS = ("cell_global", "vertex_global", "edge_global",
                "cell_owned_mask", "vertex_owned_mask", "cell_export_idx",
                "vertex_export_idx", "cell_halo_src_shard",
                "cell_halo_src_idx", "vertex_halo_src_shard",
                "vertex_halo_src_idx")


def _halo_edges(part):
    edges = set()
    for s, b in enumerate(part.blocks):
        cv = b.cell_global[b.n_cells_owned:] >= 0
        vv = b.vertex_global[b.n_vertices_owned:] >= 0
        for r in np.unique(b.cell_halo_src_shard[cv]):
            edges.add((int(r), s))
        for r in np.unique(b.vertex_halo_src_shard[vv]):
            edges.add((int(r), s))
    return edges


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_matches_reference_bitwise(case):
    make, n = CASES[case]
    pj, pt = jpartition(make("j"), n), tpartition(make("t"), n)
    assert pt.n_shards == pj.n_shards == n
    _equal(pt.cell_owner, pj.cell_owner, "cell_owner")
    _equal(pt.vertex_owner, pj.vertex_owner, "vertex_owner")
    assert pt.min_dv_edge == pj.min_dv_edge
    for s, (bj, bt) in enumerate(zip(pj.blocks, pt.blocks)):
        for k in ("n_cells_owned", "n_vertices_owned", "n_edges_owned"):
            assert getattr(bt, k) == getattr(bj, k), (s, k)
        for k in BLOCK_ARRAYS:
            _equal(getattr(bt, k), getattr(bj, k), (s, k))
        mj, mt = bj.mesh, bt.mesh
        for f in mt.__dataclass_fields__:
            a, b = getattr(mt, f), getattr(mj, f)
            if isinstance(b, np.ndarray):
                _equal(a, b, (s, "mesh", f))
            else:
                assert a == b, (s, "mesh", f)
    # the rounds of the ring exchange are the reference's
    edges = _halo_edges(pt)
    assert edges == _halo_edges(pj)
    assert tcolor(edges, n) == jcolor(edges, n)


def test_halo_rounds_are_sparse_and_cover_every_edge():
    """The 64 x 64 / 32-block case of the JAX package's ring test: few
    rounds, every halo edge in exactly one, each round a partial
    permutation; and the ring's gather table gives every real halo slot
    the entry the all-gather addresses."""
    part = tpartition(tbox.box_test_mesh(64, 64), 32)
    edges = _halo_edges(part)
    perms, color_of = tcolor(edges, 32)
    assert len(perms) < 32 // 2
    assert {e for p in perms for e in p} == edges
    for p in perms:
        assert len({r for r, _ in p}) == len(p)
        assert len({s for _, s in p}) == len(p)
    for s, b in enumerate(part.blocks):
        valid = b.vertex_global[b.n_vertices_owned:] >= 0
        color = np.array([color_of[(int(r), s)] if ok else -1 for r, ok in
                          zip(b.vertex_halo_src_shard, valid)])
        n_exp = len(b.vertex_export_idx)
        args = (s, b.vertex_halo_src_shard, b.vertex_halo_src_idx, color,
                perms, n_exp, 32)
        ring = halo_gather_table("ring", *args)
        gather = halo_gather_table("allgather", *args)
        assert np.array_equal(ring[valid], gather[valid])
        assert (ring[~valid] == 32 * n_exp).all()     # the zero entry
