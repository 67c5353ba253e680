"""Nothing the benchmark runs loads JAX or the JAX package: no source
under benchmark/ imports a module whose top-level name is `jax`,
`jaxlib`, `flax` or `seaice_tpu` (compared whole: the port's name begins
with the JAX package's), and a run's process holds none of them when it
ends (the harness checks `sys.modules` itself and prints no result)."""

import ast
import os
import subprocess
import sys

from benchmark.harness.cli import FORBIDDEN
from benchmark.harness.manifest import BENCH_DIR

from .small import ROOT


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    found = []
    for d, _, names in os.walk(BENCH_DIR):
        for n in names:
            if n.endswith(".py"):
                p = os.path.join(d, n)
                bad = set(imported_top_levels(p)) & set(FORBIDDEN)
                if bad:
                    found.append((os.path.relpath(p, ROOT), sorted(bad)))
    assert not found


def test_whole_names_compared():
    """`seaice_tpu_torch` is not the JAX package, `seaice_tpu` is."""
    code = ("import sys; sys.modules['seaice_tpu_torch_x'] = sys; "
            "from benchmark.harness.cli import forbidden_modules; "
            "a = forbidden_modules(); sys.modules['seaice_tpu'] = sys; "
            "print(a, forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "[] ['seaice_tpu']", r.stderr


def test_run_process_holds_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.tests.small import SMALL; "
            "from benchmark.harness.cli import main, forbidden_modules; "
            "rc = main(['--workload', 'qu60_dycore.winter_caps', '--seed', "
            "'3', '--seconds', '0.5', '--trace', '0'], device='cpu', "
            "overrides=SMALL); print(rc, forbidden_modules())" % ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.stdout.strip().splitlines()[-1] == "0 []", r.stderr[-2000:]
