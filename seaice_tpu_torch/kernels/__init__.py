"""The package's hand-written GPU kernels: where they are, and how often
each was launched.

Each kernel has a wrapper beside its plain PyTorch version; the wrapper
carries a plain integer `launches` that it raises by one where it launches
its kernel, and nowhere else.  `build.py` compiles the sources.
"""


def wrappers():
    """{kernel name: wrapper function}, imported on demand."""
    from ..dynamics.cuda_panel import panel_cell_step
    from ..dynamics.cuda_panel_fused import evp_panel_loop
    from ..dynamics.cuda_raster import evp_raster_loop
    from ..dynamics.cuda_unstructured import (evp_subcycle_loop,
                                              evp_subcycle_step)
    from ..transport.cuda_flux import integrate_fluxes_cuda
    return {"evp_subcycle_loop": evp_subcycle_loop,
            "integrate_fluxes_cuda": integrate_fluxes_cuda,
            "evp_panel_loop": evp_panel_loop,
            "panel_cell_step": panel_cell_step,
            "evp_raster_loop": evp_raster_loop,
            "evp_subcycle_step": evp_subcycle_step}


def reset_launch_counts():
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "inner_launches"):
            fn.inner_launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in wrappers().items()}
