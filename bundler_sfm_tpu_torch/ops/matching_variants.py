"""Variants of the exact 2-NN on hand-written Hopper kernels
(`csrc/two_nn_variants.cu`): the matcher's epilogue probes.

Counterparts of the three TPU kernels of
`benchmarks/probes/probe_pallas_variants.py`, batched over the pairs of one
descriptor table the way that file's `batched` vmaps them:

  two_nn_oneblock        exact 2-NN in max form, one top-2 pass per score
                         row; query tile tq in {128, 256, 512, 1024}, dot in
                         int8 or bf16 (`one_block_kernel`)
  two_nn_blockmerge_bf16 exact 2-NN, bf16 dot, 256 query rows, db in 512-row
                         blocks folded into a running top-2
                         (`bf16_resident_kernel`)
  two_nn_ablation        not a matcher: "matmul_max" (row max of f32(dot)
                         over all db rows; i0 = d1 = 0) or "top1" (nearest
                         neighbour only; d1 = 0), tq 128, int8 dot
                         (`ablation_kernel`)

Each takes (table, counts, pi, pj): a centered int8 table [n_img, K, 128],
int32 counts [n_img] and int32 pair indices [B]; pair b queries all K rows
of table[pi[b]] against the first counts[pj[b]] rows of table[pj[b]].
Outputs d0 f32, i0 int32, d1 f32, each [B, K].  The arithmetic is exact
(half-integers below 2²³), so the exact variants are bit-identical to
`matching_cuda.two_nn_pairs(table, table, counts, pi, pj)`.

For CPU tensors a wrapper runs its plain PyTorch version (the query tile
and the dot type do not change the result); for CUDA tensors it launches
the kernel or raises.  Bound on an H100: 2·128·K² int8 tensor-core
operations per pair (see the source note).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from bundler_sfm_tpu_torch.ops.matching_cuda import BIG, build

SOURCE = "two_nn_variants.cu"
ONEBLOCK_TILES = (128, 256, 512, 1024)
DOTS = ("int8", "bf16")
ABLATION_MODES = ("matmul_max", "top1")
BLOCKMERGE_TQ = 256
BLOCKMERGE_BD = 512
ABLATION_TQ = 128

# Kernel launches, one count per kernel instantiation the wrappers reach.
LAUNCHES = {**{f"two_nn_oneblock_{d}_{tq}": 0 for d in DOTS
               for tq in ONEBLOCK_TILES},
            "two_nn_blockmerge_bf16": 0,
            **{f"two_nn_ablation_{m}": 0 for m in ABLATION_MODES}}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(SOURCE))
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, i, p, p, p, i]              # table, K, counts, pi, pj, B
        tail = [p, p, p, p]                    # d0, i0, d1, stream
        for name, extra in (("two_nn_oneblock", [i, i]),
                            ("two_nn_blockmerge_bf16", []),
                            ("two_nn_ablation", [i])):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = head + extra + tail
        _lib = lib
    return _lib


# ---------------------------------------------------------------- plain ----

def _half_norms(table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """0.5·|b|² per db row [n_img, K] f32, poisoned to 0.5·3e38 for rows at
    or past the count (the probe's `batched`)."""
    t = table.int()
    bsq = (t * t).sum(-1).float()
    row = torch.arange(table.shape[1], device=table.device)
    bsq = torch.where(row < counts[:, None], bsq, torch.full_like(bsq, BIG))
    return 0.5 * bsq


def _top2(m: torch.Tensor, col: torch.Tensor):
    """`_tile_top2`: the two largest scores of each row and the first column
    of the largest."""
    m0 = m.amax(-1)
    i0 = torch.where(m == m0[..., None], col, 2 ** 30).amin(-1)
    m1 = torch.where(col == i0[..., None], -BIG, m).amax(-1)
    return m0, i0, m1


def _merge_top2(r0, ri, r1, m0, i0, m1):
    """`_merge_top2`: fold a block's top-2 into the running one; ties keep
    the running entry."""
    a_first = r0 >= m0
    return (torch.where(a_first, r0, m0), torch.where(a_first, ri, i0),
            torch.maximum(torch.where(a_first, m0, r0),
                          torch.where(a_first, r1, m1)))


def _pairs_plain(kind: str, table, counts, pi, pj, chunk_elems=1 << 26
                 ) -> Outputs:
    """The plain version of one variant over the pair list, in chunks that
    bound the [chunk, K, K] score temporaries."""
    K = table.shape[1]
    hb = _half_norms(table, counts)
    qsq = (table.int() * table.int()).sum(-1).float()
    col = torch.arange(K, device=table.device)
    step = max(1, chunk_elems // (K * K))
    outs = []
    for s in range(0, len(pi), step):
        a, b = pi[s:s + step].long(), pj[s:s + step].long()
        # Exact in f32: products <= 128², sums < 2²⁴ (TF32 is off).
        dots = table[a].float() @ table[b].float().transpose(1, 2)
        zero_i = torch.zeros((len(a), K), dtype=torch.int32,
                             device=table.device)
        if kind == "matmul_max":
            outs.append((dots.amax(-1), zero_i, torch.zeros_like(dots[..., 0])))
            continue
        m = dots - hb[b][:, None, :]
        if kind == "blockmerge":
            r0 = torch.full_like(m[..., 0], -BIG)
            ri = torch.zeros_like(zero_i)
            r1 = r0.clone()
            for start in range(0, K, BLOCKMERGE_BD):
                m0, i0, m1 = _top2(m[..., start:start + BLOCKMERGE_BD],
                                   col[:BLOCKMERGE_BD])
                r0, ri, r1 = _merge_top2(r0, ri, r1, m0, start + i0, m1)
            m0, i0, m1 = r0, ri, r1
        else:
            m0, i0, m1 = _top2(m, col)
        d0 = qsq[a] - 2.0 * m0
        d1 = (qsq[a] - 2.0 * m1 if kind != "top1"
              else torch.zeros_like(d0))
        outs.append((d0, i0.int(), d1))
    if not outs:
        empty = torch.empty((0, K), device=table.device)
        return empty, empty.int(), empty.clone()
    return tuple(torch.cat(o) for o in zip(*outs))


def oneblock_plain(table, counts, pi, pj) -> Outputs:
    return _pairs_plain("oneblock", table, counts, pi, pj)


def blockmerge_plain(table, counts, pi, pj) -> Outputs:
    return _pairs_plain("blockmerge", table, counts, pi, pj)


def ablation_plain(table, counts, pi, pj, mode: str) -> Outputs:
    if mode not in ABLATION_MODES:
        raise ValueError(f"two_nn_ablation: unknown mode {mode!r}; "
                         f"expected one of {ABLATION_MODES}")
    return _pairs_plain(mode, table, counts, pi, pj)


# ------------------------------------------------------------- wrappers ----

def _check(name: str, table, counts, pi, pj, row_multiple: int) -> None:
    """Device, dtype, shape, divisibility and index checks shared by every
    wrapper; one device sync for the index ranges."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {table.device}")
    if table.dtype != torch.int8:
        raise ValueError(f"{name}: the table must be centered int8, "
                         f"got {table.dtype}")
    if table.dim() != 3 or table.shape[2] != 128:
        raise ValueError(f"{name}: the table must be [n_img, K, 128], "
                         f"got {tuple(table.shape)}")
    n_img, K = table.shape[0], table.shape[1]
    if K == 0 or K % row_multiple:
        raise ValueError(f"{name}: need K % {row_multiple} == 0 and K > 0, "
                         f"got K = {K}")
    for label, t in (("counts", counts), ("pi", pi), ("pj", pj)):
        if t.device != table.device:
            raise ValueError(f"{name}: {label} on {t.device}, "
                             f"table on {table.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {label} must be int32")
    if counts.shape != (n_img,) or pi.dim() != 1 or pj.shape != pi.shape:
        raise ValueError(f"{name}: counts must be [n_img], pi and pj [B]")
    if bool(((pi < 0) | (pi >= n_img)).any() | ((pj < 0) | (pj >= n_img)).any()
            | ((counts < 0) | (counts > K)).any()):
        raise ValueError(f"{name}: image index or count out of range")


def _run(name: str, counter: str, plain: Callable[[], Outputs],
         launch: Callable, table, counts, pi, pj, row_multiple: int
         ) -> Outputs:
    _check(name, table, counts, pi, pj, row_multiple)
    if table.device.type == "cpu":
        return plain()
    table, counts = table.contiguous(), counts.contiguous()
    pi, pj = pi.contiguous(), pj.contiguous()
    B, K = pi.shape[0], table.shape[1]
    d0 = torch.empty((B, K), dtype=torch.float32, device=table.device)
    i0 = torch.empty((B, K), dtype=torch.int32, device=table.device)
    d1 = torch.empty((B, K), dtype=torch.float32, device=table.device)
    if B == 0:
        return d0, i0, d1
    lib = _load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(lib, (table.data_ptr(), K, counts.data_ptr(),
                           pi.data_ptr(), pj.data_ptr(), B),
                     (d0.data_ptr(), i0.data_ptr(), d1.data_ptr(), stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
    return d0, i0, d1


def two_nn_oneblock(table: torch.Tensor, counts: torch.Tensor,
                    pi: torch.Tensor, pj: torch.Tensor, tq: int = 128,
                    dot: str = "int8") -> Outputs:
    """Exact 2-NN with a one-pass top-2 over each score row; tq query rows
    share each staged db tile (K % tq == 0); dot "int8" or "bf16"."""
    if tq not in ONEBLOCK_TILES:
        raise ValueError(f"two_nn_oneblock: tq must be one of "
                         f"{ONEBLOCK_TILES}, got {tq}")
    if dot not in DOTS:
        raise ValueError(f"two_nn_oneblock: dot must be one of {DOTS}, "
                         f"got {dot!r}")
    return _run("two_nn_oneblock", f"two_nn_oneblock_{dot}_{tq}",
                lambda: oneblock_plain(table, counts, pi, pj),
                lambda lib, head, tail: lib.two_nn_oneblock(
                    *head, tq, int(dot == "bf16"), *tail),
                table, counts, pi, pj, tq)


def two_nn_blockmerge_bf16(table: torch.Tensor, counts: torch.Tensor,
                           pi: torch.Tensor, pj: torch.Tensor) -> Outputs:
    """Exact 2-NN with a bf16 dot, 256 query rows per block and the db in
    512-row blocks folded into a running top-2 (K % 512 == 0)."""
    return _run("two_nn_blockmerge_bf16", "two_nn_blockmerge_bf16",
                lambda: blockmerge_plain(table, counts, pi, pj),
                lambda lib, head, tail: lib.two_nn_blockmerge_bf16(
                    *head, *tail),
                table, counts, pi, pj, BLOCKMERGE_BD)


def two_nn_ablation(table: torch.Tensor, counts: torch.Tensor,
                    pi: torch.Tensor, pj: torch.Tensor, mode: str) -> Outputs:
    """Epilogue ablation (not a matcher), int8 dot, 128 query rows
    (K % 128 == 0): mode "matmul_max" or "top1"."""
    if mode not in ABLATION_MODES:
        raise ValueError(f"two_nn_ablation: unknown mode {mode!r}; "
                         f"expected one of {ABLATION_MODES}")
    return _run("two_nn_ablation", f"two_nn_ablation_{mode}",
                lambda: ablation_plain(table, counts, pi, pj, mode),
                lambda lib, head, tail: lib.two_nn_ablation(
                    *head, ABLATION_MODES.index(mode), *tail),
                table, counts, pi, pj, ABLATION_TQ)
