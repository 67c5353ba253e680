"""The benchmark's own copies of the work counts equal the port's
functions at several shapes."""

import numpy as np
import pytest
import torch

from benchmark.harness import work
from seaice_tpu_torch.dynamics import cuda_panel_fused
from seaice_tpu_torch.transport import cuda_flux
from seaice_tpu_torch.transport.tracers import standard_tracer_tree


@pytest.mark.parametrize("N", [4, 64, 128])
@pytest.mark.parametrize("metric", [True, False])
def test_evp_panel_loop_work(N, metric):
    for itemsize in (4, 8):
        args = (N, 120, metric, itemsize)
        assert work.evp_panel_loop_work(*args) == \
            cuda_panel_fused.evp_panel_loop_work(*args)


@pytest.mark.parametrize("n_layers", [1, 7])
@pytest.mark.parametrize("nE,S", [(30, 6), (500, 12)])
def test_flux_work(n_layers, nE, S):
    g = torch.Generator().manual_seed(nE * S + n_layers)
    tree = standard_tracer_tree(n_ice_layers=n_layers, n_snow_layers=1)
    nc, ncat = 40, 5
    recon = {}
    for s in tree.specs:
        shape = (nc, ncat) + ((s.n_layers,) if s.n_layers else ())
        recon[s.name] = {"center": torch.zeros(shape)}
    cell = torch.randint(0, nc, (nE, S), generator=g)
    area = torch.where(torch.rand(nE, S, generator=g) < 0.4, 0.0,
                       torch.rand(nE, S, generator=g))
    mask = (torch.rand(nE, generator=g) < 0.8).double()
    for itemsize in (4, 8):
        got = work.flux_work(tree, recon, cell, area, mask, itemsize)
        want = cuda_flux.flux_work(tree, recon, cell, area, mask, itemsize)
        assert got == want
    assert np.isfinite(got[0])
