"""The benchmark's plain reference for the dynamical-core cells: the
configuration's step (the EVP velocity solve on Wachspress functions and
incremental remapping of the tracer tree) written from MPAS-Seaice's
equations in plain PyTorch, on the benchmark's own icosahedral mesh.  It
imports nothing of the program; `harness/compare.py` sets its answers
beside the program's."""
