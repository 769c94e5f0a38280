"""Fused exact 2-NN on hand-written Hopper kernels (`csrc/two_nn.cu`).

Replaces `bundler_sfm_tpu/ops/matching_pallas.py::two_nn_pallas` (the
TPU kernel and its three VMEM-sized variants), batched over image pairs
the way `ops/matching.py::_match_pairs_from_table_masked` vmaps it: the
kernel reads each pair's image indices and fetches its query and db rows
itself, so no [B, K, 128] stacks are materialised, and the [K, K]
distance tile never reaches device memory.

Bound on an H100: 2·B·Nq·Nd·128 int8 tensor-core operations (1979 TOP/s,
4096 int8 MAC a clock per SM), beside B·Nq·Nd top-2 updates on the CUDA
cores.  The first design (kept as `two_nn_pairs_mma`) fed `mma.sync` from
8 warps that each loaded their own B fragments from shared memory: 256 B
per m16n8k32, twice the 128 B a clock shared memory gives, with the db
tiles staged synchronously and an epilogue of ~6 integer instructions a
score.  The int8 kernel now runs two consumer warpgroups of `wgmma`
m64n128k32 (A in registers, B from a 128-byte-swizzled TMA ring kept
full by a producer warp: 64 B a clock), folds packed (distance, column)
keys at 4 integer instructions a score, and overlaps each tile's top-2
with the next tile's product; that epilogue is what bounds it now (see
the source note for the arithmetic).  An int8 call is one launch: its
first phase writes the column constants of the db table, and the grid
meets at a barrier before the ring starts.  f32 tables run the same
machinery
at the bf16 rate (`wgmma` m64n128k16 on bf16 copies of the tables written
by a per-call pre-pass, with the norms of the unrounded values) and keep
the top-2 in f32.

Wrappers, each counting its kernel launches in `LAUNCHES`:
  two_nn_pairs     the matcher.  int8: the `wgmma` kernel, which writes
                   its column constants itself ("two_nn"); f32:
                   `prepass_f32` then the bf16 `wgmma` kernel ("two_nn_f32").
  two_nn_product_max  the `wgmma` kernel with one max a score in place of
                   the top-2 (row max of q·b), int8 ("two_nn_product_max")
                   or f32 ("two_nn_product_max_f32"): splits its time, not
                   a matcher.
  prepass_f32      the f32 kernel's bf16 table, |x|² and column norms
                   ("two_nn_f32_prepass").
Yardsticks, for comparison only (no path calls them):
  two_nn_pairs_two_launch, two_nn_product_max_two_launch  the int8
                   kernels' two-launch form: `two_nn_norms`, then the same
                   kernel reading those constants ("two_nn_two_launch",
                   "two_nn_product_max_two_launch").
  two_nn_norms     |b|²·256 + row % 128 per table row, poisoned past the
                   count: the int8 kernel's per-column constants.
  two_nn_pairs_mma the first design (`mma.sync`), int8 ("two_nn_mma") or
                   f32 ("two_nn_f32_mma").
For CPU tensors each runs its plain PyTorch version (`two_nn_reference`,
`two_nn_norms_plain`, `prepass_f32_plain`, `product_max_plain`); for CUDA
tensors it launches its kernel or raises.
The library is built with `nvcc` from the sources in this package at
first use, into `build/kernels/` at the repository root; `csrc/two_nn.cu`
shares its TMA ring, `wgmma` and packed-key helpers with
`csrc/two_nn_variants.cu` through `csrc/wgmma_ring.cuh`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import torch

BIG = 3.0e38
QUERY_TILE = 128      # query rows per kernel work item
DB_TILE = 64          # db rows per image must be a multiple of this
NORM_TILE = 128       # db rows per ring stage of the int8 kernel
KEY_POISON = 0x7FFFFFFF

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches, one count per kernel: "two_nn" (the int8 `wgmma`
# kernel), "two_nn_f32" (the f32 `wgmma` kernel), "two_nn_f32_prepass",
# "two_nn_product_max" / "two_nn_product_max_f32" (the `wgmma` kernels'
# product-only ablations), and the yardsticks: "two_nn_norms",
# "two_nn_two_launch" / "two_nn_product_max_two_launch" (the int8 kernels
# reading the norms kernel's constants) and "two_nn_mma" /
# "two_nn_f32_mma" (the first design's `mma.sync` kernels).
LAUNCHES = {"two_nn": 0, "two_nn_f32": 0, "two_nn_f32_prepass": 0,
            "two_nn_product_max": 0, "two_nn_product_max_f32": 0,
            "two_nn_norms": 0, "two_nn_two_launch": 0,
            "two_nn_product_max_two_launch": 0, "two_nn_mma": 0,
            "two_nn_f32_mma": 0}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(source: str = "two_nn.cu", verbose: bool = False,
          force: bool = False) -> str:
    """Compile `csrc/<source>` into its own library in `build/kernels/`,
    named after the source and keyed by the hash of the source, the headers
    beside it (`csrc/*.cuh`) and the flags (an edited source or header
    rebuilds; `force` rebuilds anyway); returns the library path.
    `verbose` prints what ptxas reports of each kernel."""
    src = os.path.join(_CSRC, source)
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(os.path.join(_CSRC, f) for f in
                               os.listdir(_CSRC) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    out = os.path.join(_BUILD_DIR, f"lib{stem}_{digest}.so")
    if os.path.exists(out) and not force:
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
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # qtab, q_stride, nq, dbtab, n_img, nd, counts, norms, two_launch,
        # pi, pj, B, d0, i0, d1, stream
        ws = [p, ll, i, p, i, i, p, p, i, p, p, i, p, p, p, p]
        # q16, q_stride, n_img_q, nq, qsq, db16, n_img, nd, counts, bsq,
        # pi, pj, B, d0, i0, d1, stream
        f32 = [p, ll, i, i, p, p, i, i, p, p, p, p, i, p, p, p, p]
        mma = [p, ll, i, p, ll, p, p, p, i, p, p, p, p]
        for name, args in (("two_nn_pairs_i8", ws),
                           ("two_nn_product_max_i8", ws),
                           ("two_nn_norms_i8", [p, i, i, p, p, p]),
                           ("two_nn_pairs_f32", f32),
                           ("two_nn_product_max_f32", f32),
                           ("two_nn_prepass_f32", [p, i, i, p, p, p, p, p]),
                           ("two_nn_pairs_i8_mma", mma),
                           ("two_nn_pairs_f32_mma", mma)):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = args
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


# The f32 kernels on real-valued tables: the tensor cores sum the 128
# products of a dot in another order (and with other intermediate
# roundings) than the plain version's matrix product, so a distance may
# differ by a few ulps of |q|^2 + |b|^2.  They are held to |d - d_plain| <=
# F32_REL_TOL * (|q|^2 + |b|^2), with |b|^2 the largest over the pair's valid
# db rows, and to the plain version's i0 wherever its d1 - d0 exceeds twice
# that.  On integer-valued tables (|x| <= 255) they are exact.
F32_REL_TOL = 1e-5


def f32_tolerance(qtab, dbtab, db_counts, pi, pj) -> torch.Tensor:
    """The tolerance of each output row [B, Nq] (see F32_REL_TOL)."""
    qsq = (qtab.float() ** 2).sum(-1)
    bsq = (dbtab.float() ** 2).sum(-1)
    col = torch.arange(dbtab.shape[1], device=dbtab.device)
    bmax = torch.where(col < db_counts[:, None].long(), bsq,
                       torch.zeros_like(bsq)).amax(-1)
    return F32_REL_TOL * (qsq[pi.long()] + bmax[pj.long()][:, None])


def f32_mismatches(got, want, tol) -> list:
    """Counts of d0, i0 and d1 entries of `got` outside the tolerance `tol`
    [B, Nq] around `want` (the plain version's): a finite distance off by
    more than tol, a 3e38 one not equal, an i0 not equal where want's
    d1 - d0 > 2 tol."""
    bad = []
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        fin = w < BIG
        bad.append(int(((g - w).abs() > tol)[fin].sum())
                   + int((g != w)[~fin].sum()))
    sep = (want[2] - want[0]) > 2 * tol
    bad.insert(1, int((got[1] != want[1])[sep].sum()))
    return bad


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


def two_nn_norms_plain(dbtab: torch.Tensor, db_counts: torch.Tensor
                       ) -> torch.Tensor:
    """The int8 kernel's per-column constants, int32 [n_img, Kp] with Kp =
    Nd rounded up to NORM_TILE: |b|²·256 + row % NORM_TILE for rows below
    the count, KEY_POISON for the rest (padding included)."""
    n_img, nd = dbtab.shape[0], dbtab.shape[1]
    kp = -(-nd // NORM_TILE) * NORM_TILE
    t = dbtab.int()
    bsq = torch.nn.functional.pad((t * t).sum(-1), (0, kp - nd))
    row = torch.arange(kp, device=dbtab.device)
    c = bsq * 256 + row % NORM_TILE
    return torch.where(row < db_counts[:, None].long(), c,
                       torch.full_like(c, KEY_POISON)).int()


def prepass_f32_plain(tab: torch.Tensor, counts: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """The f32 kernel's per-call pre-pass over an f32 table [n_img, N,
    128]: its bf16 copy, |x|² f32 [n_img, N] from the unrounded values in
    the kernel's order (16 elements a lane in sequence, then a tree over
    the 8 lanes of a row, each product and sum rounded to f32), and with
    `counts` the column norms f32 [n_img, Kp] (Kp = N rounded up to
    NORM_TILE; BIG at or past the count and in the padding), else None."""
    x = tab.float()
    parts = (x * x).reshape(*x.shape[:2], 8, 16)
    s = parts[..., 0]
    for k in range(1, 16):
        s = s + parts[..., k]
    while s.shape[-1] > 1:               # lanes p and p ^ 1, then ^ 2, ^ 4
        s = s[..., 0::2] + s[..., 1::2]
    sq = s[..., 0]
    bsq = None
    if counts is not None:
        n_img, n = tab.shape[0], tab.shape[1]
        kp = -(-n // NORM_TILE) * NORM_TILE
        bsq = torch.nn.functional.pad(sq, (0, kp - n))
        row = torch.arange(kp, device=tab.device)
        bsq = torch.where(row < counts[:, None].long(), bsq,
                          torch.full_like(bsq, BIG))
    return tab.to(torch.bfloat16), sq, bsq


def _check_tables(qtab, dbtab, db_counts, pi, pj, dtypes):
    """Device, dtype, shape and index checks of the pair wrappers (which
    run them on CUDA tensors; CPU tensors pass the device check, so the
    messages can be tested anywhere); one device sync for the index
    ranges."""
    if qtab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"two_nn_pairs: unsupported device {qtab.device}")
    dtype = qtab.dtype
    if dtype not in dtypes or dbtab.dtype != dtype:
        names = " or ".join({torch.int8: "int8", torch.float32: "f32"}[d]
                            for d in dtypes)
        raise ValueError(f"two_nn_pairs: tables must both be {names}, "
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
    # The kernels index with these: out-of-range values would read past
    # the tables.
    if B and bool(((pi < 0) | (pi >= n_img_q)).any()
                  | ((pj < 0) | (pj >= n_img_d)).any()
                  | ((db_counts < 0) | (db_counts > nd)).any()):
        raise ValueError("two_nn_pairs: image index or db count out of range")


def _outputs(B, nq, device, scratch=0):
    """d0 f32, i0 int32, d1 f32 [B, nq] and `scratch` int32 elements for
    the kernel: views of one allocation."""
    n = B * nq
    buf = torch.empty(3 * n + scratch, dtype=torch.int32, device=device)
    return (buf[:n].view(torch.float32).view(B, nq), buf[n:2 * n].view(B, nq),
            buf[2 * n:3 * n].view(torch.float32).view(B, nq), buf[3 * n:])


def _launched(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def prepass_f32(tab: torch.Tensor, counts: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """`prepass_f32_plain` of an f32 table [n_img, N, 128] (and its int32
    counts [n_img]); on CUDA by the pre-pass kernel ("two_nn_f32_prepass").
    Writes new tensors: the caller's table is only read."""
    if tab.device.type == "cpu":
        return prepass_f32_plain(tab, counts)
    if (tab.device.type != "cuda" or tab.dtype != torch.float32
            or tab.dim() != 3 or tab.shape[2] != 128
            or (counts is not None and (
                counts.device != tab.device or counts.dtype != torch.int32
                or counts.shape != tab.shape[:1]))):
        raise ValueError("prepass_f32: need a CUDA f32 [n_img, N, 128] table "
                         "and int32 [n_img] counts on the same device")
    tab = tab.contiguous()
    n_img, n = tab.shape[0], tab.shape[1]
    tab16 = torch.empty(tab.shape, dtype=torch.bfloat16, device=tab.device)
    sq = torch.empty((n_img, n), dtype=torch.float32, device=tab.device)
    bsq = None
    if counts is not None:
        counts = counts.contiguous()
        bsq = torch.empty((n_img, -(-n // NORM_TILE) * NORM_TILE),
                          dtype=torch.float32, device=tab.device)
    if tab.numel():
        with torch.cuda.device(tab.device):
            err = _load().two_nn_prepass_f32(
                tab.data_ptr(), n_img, n,
                None if counts is None else counts.data_ptr(),
                tab16.data_ptr(), sq.data_ptr(),
                None if bsq is None else bsq.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _launched(err, "two_nn_f32_prepass")
    return tab16, sq, bsq


def two_nn_norms(dbtab: torch.Tensor, db_counts: torch.Tensor
                 ) -> torch.Tensor:
    """`two_nn_norms_plain` of a centered int8 table [n_img, Nd, 128] and
    its int32 counts [n_img]; on CUDA by the norms kernel (the two-launch
    yardstick's first launch: the int8 kernels compute these themselves)."""
    if dbtab.device.type == "cpu":
        return two_nn_norms_plain(dbtab, db_counts)
    if dbtab.device.type != "cuda" or db_counts.device != dbtab.device:
        raise ValueError(f"two_nn_norms: table on {dbtab.device}, counts "
                         f"on {db_counts.device}")
    if (dbtab.dtype != torch.int8 or dbtab.dim() != 3
            or dbtab.shape[2] != 128 or db_counts.dtype != torch.int32
            or db_counts.shape != dbtab.shape[:1]):
        raise ValueError("two_nn_norms: need an int8 [n_img, Nd, 128] table "
                         "and int32 [n_img] counts")
    dbtab, db_counts = dbtab.contiguous(), db_counts.contiguous()
    n_img, nd = dbtab.shape[0], dbtab.shape[1]
    out = torch.empty((n_img, -(-nd // NORM_TILE) * NORM_TILE),
                      dtype=torch.int32, device=dbtab.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dbtab.device):
        err = _load().two_nn_norms_i8(
            dbtab.data_ptr(), n_img, nd, db_counts.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _launched(err, "two_nn_norms")
    return out


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
    _check_tables(qtab, dbtab, db_counts, pi, pj,
                  (torch.int8, torch.float32))
    if qtab.dtype == torch.float32:
        return _launch_f32(qtab, dbtab, db_counts, pi, pj, "two_nn_f32")
    return _launch_ws(qtab, dbtab, db_counts, pi, pj, "two_nn")


def two_nn_pairs_two_launch(qtab: torch.Tensor, dbtab: torch.Tensor,
                            db_counts: torch.Tensor, pi: torch.Tensor,
                            pj: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """`two_nn_pairs` of centered int8 tables in its two-launch form: the
    norms kernel, then the `wgmma` kernel reading its constants
    ("two_nn_two_launch"); for timing and checks beside the one-launch
    kernel."""
    if qtab.device.type == "cpu":
        return _two_nn_pairs_plain(qtab, dbtab, db_counts, pi, pj)
    _check_tables(qtab, dbtab, db_counts, pi, pj, (torch.int8,))
    return _launch_ws(qtab, dbtab, db_counts, pi, pj, "two_nn_two_launch",
                      two_launch=True)


def product_max_plain(qtab, dbtab, db_counts, pi, pj, chunk_elems=1 << 26):
    """The product-only ablation's plain version: d0 = max of q·b over the
    first db_counts[pj[b]] rows (−3e38 if none), i0 = d1 = 0, on the
    centered int8 or the bf16-rounded f32 values.  Exact in f32 for int8
    (|q·b| ≤ 2²¹) and for integer-valued f32 tables with |x| ≤ 255."""
    nq, nd = qtab.shape[1], dbtab.shape[1]
    step = max(1, chunk_elems // max(nq * nd, 1))
    col = torch.arange(nd, device=qtab.device)
    d0 = torch.empty((len(pi), nq), device=qtab.device)
    if qtab.dtype == torch.float32:
        qtab = qtab.to(torch.bfloat16)
        dbtab = dbtab.to(torch.bfloat16)
    for s in range(0, len(pi), step):
        a, b = pi[s:s + step].long(), pj[s:s + step].long()
        dots = qtab[a].float() @ dbtab[b].float().transpose(1, 2)
        dots = dots.masked_fill(col >= db_counts[b][:, None, None], -BIG)
        d0[s:s + step] = dots.amax(-1)
    zeros = torch.zeros_like(d0)
    return d0, zeros.int(), zeros


def two_nn_product_max(qtab: torch.Tensor, dbtab: torch.Tensor,
                       db_counts: torch.Tensor, pi: torch.Tensor,
                       pj: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`product_max_plain` of centered int8 or f32 tables; on CUDA by the
    `wgmma` 2-NN kernel of that type with its top-2 epilogue replaced by one
    max a score."""
    if qtab.device.type == "cpu":
        return product_max_plain(qtab, dbtab, db_counts, pi, pj)
    _check_tables(qtab, dbtab, db_counts, pi, pj,
                  (torch.int8, torch.float32))
    if qtab.dtype == torch.float32:
        return _launch_f32(qtab, dbtab, db_counts, pi, pj,
                           "two_nn_product_max_f32")
    return _launch_ws(qtab, dbtab, db_counts, pi, pj, "two_nn_product_max")


def two_nn_product_max_two_launch(qtab: torch.Tensor, dbtab: torch.Tensor,
                                  db_counts: torch.Tensor, pi: torch.Tensor,
                                  pj: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """`two_nn_product_max` of centered int8 tables in its two-launch form
    (the norms kernel first; "two_nn_product_max_two_launch")."""
    if qtab.device.type == "cpu":
        return product_max_plain(qtab, dbtab, db_counts, pi, pj)
    _check_tables(qtab, dbtab, db_counts, pi, pj, (torch.int8,))
    return _launch_ws(qtab, dbtab, db_counts, pi, pj,
                      "two_nn_product_max_two_launch", two_launch=True)


def _launch_f32(qtab, dbtab, db_counts, pi, pj, counter):
    """The f32 `wgmma` kernel: the 2-NN ("two_nn_f32") or its product-only
    ablation; the pre-pass first, once for a query table that is the db
    table (as `DescriptorTable` passes it), else once for each."""
    dbtab, db_counts = dbtab.contiguous(), db_counts.contiguous()
    pi, pj = pi.contiguous(), pj.contiguous()
    B, nq = pi.shape[0], qtab.shape[1]
    d0, i0, d1, _ = _outputs(B, nq, qtab.device)
    if B == 0:
        return d0, i0, d1
    db16, sq, bsq = prepass_f32(dbtab, db_counts)
    if qtab.data_ptr() == dbtab.data_ptr() and qtab.shape == dbtab.shape \
            and qtab.is_contiguous():
        q16, qsq = db16, sq
    else:
        q16, qsq, _ = prepass_f32(qtab)
    fn = (_load().two_nn_pairs_f32 if counter == "two_nn_f32"
          else _load().two_nn_product_max_f32)
    with torch.cuda.device(qtab.device):
        err = fn(q16.data_ptr(), nq * 128, q16.shape[0], nq, qsq.data_ptr(),
                 db16.data_ptr(), dbtab.shape[0], dbtab.shape[1],
                 db_counts.data_ptr(), bsq.data_ptr(), pi.data_ptr(),
                 pj.data_ptr(), B, d0.data_ptr(), i0.data_ptr(),
                 d1.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _launched(err, counter)
    return d0, i0, d1


def _launch_ws(qtab, dbtab, db_counts, pi, pj, counter, two_launch=False):
    """The int8 `wgmma` kernel: the 2-NN ("two_nn") or its product-only
    ablation, one launch that writes its column constants into scratch
    allocated with the outputs; with `two_launch`, the norms kernel first
    and the kernel's instantiation that reads its constants."""
    qtab, dbtab = qtab.contiguous(), dbtab.contiguous()
    db_counts = db_counts.contiguous()
    pi, pj = pi.contiguous(), pj.contiguous()
    B, nq = pi.shape[0], qtab.shape[1]
    n_img, nd = dbtab.shape[0], dbtab.shape[1]
    kp = -(-nd // NORM_TILE) * NORM_TILE
    d0, i0, d1, norms = _outputs(B, nq, qtab.device,
                                 0 if two_launch or B == 0 else n_img * kp)
    if B == 0:
        return d0, i0, d1
    if two_launch:
        norms = two_nn_norms(dbtab, db_counts)
    lib = _load()
    fn = (lib.two_nn_product_max_i8 if "product_max" in counter
          else lib.two_nn_pairs_i8)
    with torch.cuda.device(qtab.device):
        err = fn(qtab.data_ptr(), nq * 128, nq, dbtab.data_ptr(), n_img, nd,
                 db_counts.data_ptr(), norms.data_ptr(), int(two_launch),
                 pi.data_ptr(), pj.data_ptr(), B, d0.data_ptr(),
                 i0.data_ptr(), d1.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _launched(err, counter)
    return d0, i0, d1


def two_nn_pairs_mma(qtab: torch.Tensor, dbtab: torch.Tensor,
                     db_counts: torch.Tensor, pi: torch.Tensor,
                     pj: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`two_nn_pairs` on the first design's `mma.sync` kernels (int8
    "two_nn_mma", f32 "two_nn_f32_mma"); for timing and checks beside the
    `wgmma` kernels."""
    if qtab.device.type == "cpu":
        return _two_nn_pairs_plain(qtab, dbtab, db_counts, pi, pj)
    _check_tables(qtab, dbtab, db_counts, pi, pj,
                  (torch.int8, torch.float32))
    return _launch_mma(qtab, dbtab, db_counts, pi, pj,
                       "two_nn_mma" if qtab.dtype == torch.int8
                       else "two_nn_f32_mma")


def _launch_mma(qtab, dbtab, db_counts, pi, pj, counter):
    """The `mma.sync` template: int8 (`two_nn_pairs_i8_mma`) or f32
    (`two_nn_pairs_f32_mma`)."""
    qtab, dbtab = qtab.contiguous(), dbtab.contiguous()
    db_counts = db_counts.contiguous()
    pi, pj = pi.contiguous(), pj.contiguous()
    B, nq, nd = pi.shape[0], qtab.shape[1], dbtab.shape[1]
    d0, i0, d1, _ = _outputs(B, nq, qtab.device)
    if B == 0:
        return d0, i0, d1
    lib = _load()
    fn = (lib.two_nn_pairs_i8_mma if qtab.dtype == torch.int8
          else lib.two_nn_pairs_f32_mma)
    with torch.cuda.device(qtab.device):
        err = fn(qtab.data_ptr(), nq * 128, nq, dbtab.data_ptr(), nd * 128,
                 db_counts.data_ptr(), pi.data_ptr(), pj.data_ptr(), B,
                 d0.data_ptr(), i0.data_ptr(), d1.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    _launched(err, counter)
    return d0, i0, d1
