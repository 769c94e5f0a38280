"""Builds the port's compiled sources (`csrc/`) at first use.

Each source becomes its own shared library in `build/kernels/` at the
repository root, named after the source and keyed by the hash of the
source, the flags and, for CUDA sources, the headers beside it
(`csrc/*.cuh`), so an edited source or header rebuilds.  A `.cu` source
(the kernels of `ops/`) builds with `nvcc`; a `.cc` source (host code such
as `io/bundle_text.py`'s formatter) builds with the host compiler, with
libstdc++ linked in.  A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-static-libstdc++",
             "-Wl,--exclude-libs,ALL"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _cxx() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler found: cannot build host code")
    return path


def build(source: str, verbose: bool = False, force: bool = False) -> str:
    """Compile `csrc/<source>` (`force` rebuilds even where the library of
    this hash exists); returns the library path.  `verbose` prints what
    ptxas reports of each kernel."""
    src = os.path.join(_CSRC, source)
    cuda = not source.endswith(".cc")
    flags = NVCC_FLAGS if cuda else CXX_FLAGS
    h = hashlib.sha1(" ".join(flags).encode())
    headers = sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                     if f.endswith(".cuh")) if cuda else []
    for path in [src] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    out = os.path.join(_BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(out) and not force:
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc() if cuda else _cxx(), *flags, "-o", tmp, src]
    if verbose and cuda:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, out)
    return out
