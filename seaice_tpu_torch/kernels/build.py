"""Builds the package's native code at first use.

Two kinds of source, both compiled from the files in the package and
nothing else, into `build/seaice_tpu_torch/` beside the package:

  * `csrc/*.cu`: the CUDA kernels, one `nvcc` per source, all started
    together, each into a shared library with a plain C interface that is
    loaded with `ctypes` (no PyTorch headers: a source builds in seconds);
  * `native/remap_stencil.cpp`: the host-side remap-stencil construction,
    compiled with `g++`.

Libraries are keyed by a hash of the sources and the flags, so a changed
source rebuilds and an unchanged one is reused.  A failed build raises
with the compiler's output.  Nothing here runs at import time: a model
on a card builds the CUDA libraries in its set-up (`SeaIceModel`), and
the wrappers open them at their first launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

from ..diagnostics import count, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NATIVE_SRC = os.path.join(_PKG, "native", "remap_stencil.cpp")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_libs: Dict[str, ctypes.CDLL] = {}
# {source name: library path} once `build_cuda` has run in this process,
# and the names it compiled (not found built)
_built: Dict[str, str] = {}
_compiled = set()
# compiler output (registers, spills) of the last CUDA build, by source
build_log: Dict[str, str] = {}


def build_dir() -> str:
    d = os.path.join(os.path.dirname(_PKG), "build", "seaice_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def _hash(paths, flags) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(home, "bin", "nvcc")
    if os.path.exists(exe):
        return exe
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built here")


def cuda_sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _cuda_lib_path(src: str) -> str:
    headers = glob.glob(os.path.join(CSRC, "*.cuh"))
    key = _hash([src] + headers, NVCC_FLAGS)
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(), f"lib{name}_{key}.so")


@span("setup.kernels")
def build_cuda() -> Dict[str, str]:
    """Compile every stale `csrc/*.cu`, one nvcc each, in parallel.
    Returns {source name: library path}.  Counts the nvcc runs
    (`kernels.compiled`)."""
    out = {}
    procs = []
    for src in cuda_sources():
        name = os.path.splitext(os.path.basename(src))[0]
        lib = _cuda_lib_path(src)
        out[name] = lib
        if os.path.exists(lib):
            continue
        count("kernels.compiled")
        _compiled.add(name)
        tmp = lib + f".tmp{os.getpid()}"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp, src]
        procs.append((name, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, cmd, p in procs:
        text, _ = p.communicate()
        build_log[name] = text
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    _built.update(out)
    return out


def get_cuda_lib(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu` (building every
    kernel source first where this process has not).  Counts a library
    opened from the cache, not compiled here (`kernels.loaded`)."""
    if name not in _libs:
        paths = _built or build_cuda()
        if name not in paths:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        _libs[name] = ctypes.CDLL(paths[name])
        if name not in _compiled:
            count("kernels.loaded")
    return _libs[name]


def get_native_stencil_lib() -> Optional[ctypes.CDLL]:
    """The host remap-stencil library (g++), or None where no C++
    compiler is installed (the Python stencil loops then serve)."""
    if "remap_stencil" in _libs:
        return _libs["remap_stencil"]
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    key = _hash([NATIVE_SRC], GXX_FLAGS)
    lib = os.path.join(build_dir(), f"libremap_stencil_{key}.so")
    if not os.path.exists(lib):
        tmp = lib + f".tmp{os.getpid()}"
        cmd = [gxx] + GXX_FLAGS + [NATIVE_SRC, "-o", tmp]
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"native build failed:\n{' '.join(cmd)}\n{r.stdout}")
        os.replace(tmp, lib)
    _libs["remap_stencil"] = ctypes.CDLL(lib)
    return _libs["remap_stencil"]
