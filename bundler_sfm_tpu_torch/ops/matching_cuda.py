"""Fused exact 2-NN on a hand-written Hopper kernel (`csrc/two_nn.cu`).

Replaces `bundler_sfm_tpu/ops/matching_pallas.py::two_nn_pallas` (the
TPU kernel and its three VMEM-sized variants), batched over image pairs
the way `ops/matching.py::_match_pairs_from_table_masked` vmaps it: each
block of the kernel reads its pair's image indices and gathers its query
and db rows itself, so no [B, K, 128] stacks are materialised, and the
[K, K] distance tile never reaches device memory.

Bound on an H100 (see the source note in `csrc/two_nn.cu`): 2·B·Nq·Nd·128
int8 tensor-core operations, and B·Nq·Nd compare/selects of the top-2
epilogue on the CUDA cores.

`two_nn_pairs` is the wrapper.  For CPU tensors it runs the plain PyTorch
version (`two_nn_reference`); for CUDA tensors it launches the kernel or
raises.  The library is built with `nvcc` from the sources in this package
at first use, into `build/kernels/` at the repository root.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

import torch

BIG = 3.0e38
QUERY_TILE = 128      # kernel block: 128 query rows
DB_TILE = 64          # kernel db tile: 64 rows

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches made by `two_nn_pairs` (one per call on CUDA tensors).
LAUNCHES = {"two_nn": 0}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(source: str = "two_nn.cu", verbose: bool = False) -> str:
    """Compile `csrc/<source>` into its own library in `build/kernels/`,
    named after the source and keyed by the hash of the source and the
    flags (an edited source rebuilds); returns the library path."""
    src = os.path.join(_CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    out = os.path.join(_BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name in ("two_nn_pairs_i8", "two_nn_pairs_f32"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
        _lib = lib
    return _lib


def two_nn_reference(query: torch.Tensor, db: torch.Tensor, db_count
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch exact 2-NN, batched over leading dimensions.

    query [..., Nq, 128] and db [..., Nd, 128] are centered int8 or f32;
    db_count is an int or an int tensor broadcasting over the leading dims.
    Returns (d0, i0, d1) like `ops.matching.two_nn`.  The distance product
    runs in f32 on the centered (int8) or bf16-rounded (f32) values: exact,
    since 128·128² < 2²⁴, with TF32 off.  Ties go to the first index."""
    if query.dtype == torch.int8:
        qf = query.float()
        bf = db.float()
        q_sq = (query.int() * query.int()).sum(-1).float()
        b_sq = (db.int() * db.int()).sum(-1).float()
    else:
        qf = query.to(torch.bfloat16).float()
        bf = db.to(torch.bfloat16).float()
        q_sq = (query * query).sum(-1)
        b_sq = (db * db).sum(-1)
    dots = qf @ bf.transpose(-1, -2)                         # [..., Nq, Nd]
    d = q_sq[..., :, None] + b_sq[..., None, :] - 2.0 * dots
    count = torch.as_tensor(db_count, device=d.device)
    col = torch.arange(d.shape[-1], device=d.device)
    d = torch.where(col < count[..., None, None], d, torch.full_like(d, BIG))
    i0 = torch.argmin(d, dim=-1)
    d0 = torch.gather(d, -1, i0[..., None])[..., 0]
    d.scatter_(-1, i0[..., None], BIG)
    d1 = d.amin(dim=-1)
    return d0, i0.to(torch.int32), d1


def _two_nn_pairs_plain(qtab, dbtab, db_counts, pi, pj, chunk_elems=1 << 26):
    """`two_nn_reference` over a pair list, in chunks that bound the
    [chunk, Nq, Nd] distance temporaries."""
    nq, nd = qtab.shape[1], dbtab.shape[1]
    step = max(1, chunk_elems // max(nq * nd, 1))
    outs = []
    for s in range(0, len(pi), step):
        a, b = pi[s:s + step].long(), pj[s:s + step].long()
        outs.append(two_nn_reference(qtab[a], dbtab[b], db_counts[b]))
    if not outs:
        empty = torch.empty((0, nq), device=qtab.device)
        return empty, empty.int(), empty.clone()
    return tuple(torch.cat(o) for o in zip(*outs))


def two_nn_pairs(qtab: torch.Tensor, dbtab: torch.Tensor,
                 db_counts: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact 2-NN of every query row of qtab[pi[b]] against the first
    db_counts[pj[b]] rows of dbtab[pj[b]].

    qtab [Nq_img, Nq, 128], dbtab [Nd_img, Nd, 128]: both centered int8 or
    both f32; db_counts int32 [Nd_img]; pi, pj int32 [B].  Returns d0 f32,
    i0 int32, d1 f32, each [B, Nq].  On CUDA, Nq % 128 == 0 and
    Nd % 64 == 0 (callers pad)."""
    if qtab.device.type == "cpu":
        return _two_nn_pairs_plain(qtab, dbtab, db_counts, pi, pj)
    if qtab.device.type != "cuda":
        raise ValueError(f"two_nn_pairs: unsupported device {qtab.device}")
    dtype = qtab.dtype
    if dtype not in (torch.int8, torch.float32) or dbtab.dtype != dtype:
        raise ValueError(f"two_nn_pairs: tables must both be int8 or f32, "
                         f"got {qtab.dtype} / {dbtab.dtype}")
    n_img_q, nq, dim_q = qtab.shape
    n_img_d, nd, dim_d = dbtab.shape
    if dim_q != 128 or dim_d != 128:
        raise ValueError("two_nn_pairs: descriptors must have 128 elements")
    if nq % QUERY_TILE or nd % DB_TILE:
        raise ValueError(f"two_nn_pairs: need Nq % {QUERY_TILE} == 0 and "
                         f"Nd % {DB_TILE} == 0, got {nq}, {nd}")
    for name, t in (("dbtab", dbtab), ("db_counts", db_counts), ("pi", pi),
                    ("pj", pj)):
        if t.device != qtab.device:
            raise ValueError(f"two_nn_pairs: {name} on {t.device}, "
                             f"qtab on {qtab.device}")
    for name, t in (("db_counts", db_counts), ("pi", pi), ("pj", pj)):
        if t.dtype != torch.int32:
            raise ValueError(f"two_nn_pairs: {name} must be int32")
    B = pi.shape[0]
    if pj.shape != (B,) or db_counts.shape != (n_img_d,):
        raise ValueError("two_nn_pairs: pi, pj must be [B] and db_counts "
                         "[Nd_img]")
    # The kernel indexes with these: out-of-range values would read past
    # the tables.  (One device sync.)
    if B and bool(((pi < 0) | (pi >= n_img_q)).any()
                  | ((pj < 0) | (pj >= n_img_d)).any()
                  | ((db_counts < 0) | (db_counts > nd)).any()):
        raise ValueError("two_nn_pairs: image index or db count out of range")
    qtab, dbtab = qtab.contiguous(), dbtab.contiguous()
    db_counts, pi, pj = db_counts.contiguous(), pi.contiguous(), pj.contiguous()
    d0 = torch.empty((B, nq), dtype=torch.float32, device=qtab.device)
    i0 = torch.empty((B, nq), dtype=torch.int32, device=qtab.device)
    d1 = torch.empty((B, nq), dtype=torch.float32, device=qtab.device)
    if B == 0:
        return d0, i0, d1
    lib = _load()
    fn = lib.two_nn_pairs_i8 if dtype == torch.int8 else lib.two_nn_pairs_f32
    with torch.cuda.device(qtab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qtab.data_ptr(), nq * 128, nq, dbtab.data_ptr(), nd * 128,
                 db_counts.data_ptr(), pi.data_ptr(), pj.data_ptr(), B,
                 d0.data_ptr(), i0.data_ptr(), d1.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"two_nn kernel launch failed: CUDA error {err}")
    LAUNCHES["two_nn"] += 1
    return d0, i0, d1
