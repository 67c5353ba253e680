"""seaice_tpu_torch: the PyTorch/CUDA port of the sea-ice dynamical core.

The counterpart of the JAX package `seaice_tpu`, module for module, for
an NVIDIA Hopper GPU: plain tensor code is PyTorch, and the kernels that
carry the dynamics-transport step (the EVP elastic-subcycle loop for any
mesh, for the panel-reordered sphere and for the raster box, one subcycle
per call on a block of a partitioned mesh (`parallel/`), and the
incremental-remapping flux integration) are CUDA C++ under `csrc/`,
built at first use by `kernels/build.py`.

This package imports torch and numpy only. Entry points run on the GPU
unless the caller asks for `device="cpu"`.
"""

__version__ = "0.1.0"
