"""The benchmark's plain reference: the configuration's step, as the
phases its configuration names (`model.py`; `dynamics.py`: the EVP
velocity solve on Wachspress functions and incremental remapping of the
tracer tree), written from MPAS-Seaice's equations in plain PyTorch, on
the benchmark's own icosahedral mesh.  It imports nothing of the
program; `harness/compare.py` sets its answers beside the program's."""
