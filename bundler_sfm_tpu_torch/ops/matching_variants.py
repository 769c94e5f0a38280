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

Two kernel designs (see the source note).  `two_nn_oneblock` (int8 at every
tq, bf16 at tq 128), `two_nn_blockmerge_bf16` and `two_nn_ablation` run the
warp-specialised `wgmma` design: one launch of a persistent kernel whose
first phase writes the table's column constants and |q|² (scratch
allocated with the outputs; the grid then meets at a barrier), then a TMA
ring of db tiles and a packed-key top-2 (top-1 for "top1", one max a score
and no constants for "matmul_max").  The bf16 dot reads a bf16 copy of the
table (TMA cannot convert): `bf16_table` makes it, once per table when the
caller passes it in (`table16=`), else once per call.  Yardsticks, for comparison only: the two-launch form of each
`wgmma` instantiation that reads constants (`two_nn_oneblock_two_launch`,
`two_nn_blockmerge_bf16_two_launch`, `two_nn_ablation_two_launch`: the
pre-pass kernel `variants_prepass`, then the kernel reading its constants
and |q|²), and the first design's `mma.sync` kernels
(`two_nn_oneblock_mma`, `two_nn_blockmerge_bf16_mma`,
`two_nn_ablation_mma`), which also serve `two_nn_oneblock` at bf16 tq
256–1024 (launched by no path).

For CPU tensors a wrapper runs its plain PyTorch version (the query tile,
the dot type and the design do not change the result); for CUDA tensors it
launches the kernel or raises.  Bound on an H100: 2·128·K² int8 (or bf16)
tensor-core operations per pair.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from bundler_sfm_tpu_torch.ops.matching_cuda import (
    BIG, KEY_POISON, NORM_TILE, build,
)

SOURCE = "two_nn_variants.cu"
ONEBLOCK_TILES = (128, 256, 512, 1024)
DOTS = ("int8", "bf16")
ABLATION_MODES = ("matmul_max", "top1")
BLOCKMERGE_TQ = 256
BLOCKMERGE_BD = 512
ABLATION_TQ = 128
# The bf16 column constants carry the offset that turns an f32 accumulator
# into its int32 value (acc + 1.5·2²³ read as int32 is acc + 0x4B400000, and
# 512·0x4B400000 wraps to 0x80000000).
F32_MAGIC_BIAS = 0x80000000

# Kernel launches, one count per kernel instantiation the wrappers reach:
# the probe's variants (`wgmma` design where it serves them), the pre-pass
# kernel (the bf16 table, and the yardsticks' first launch), the
# two-launch yardsticks and the first design's `mma.sync` yardsticks.
TWO_LAUNCH = ([f"two_nn_oneblock_two_launch_int8_{tq}" for tq in ONEBLOCK_TILES]
              + ["two_nn_oneblock_two_launch_bf16_128",
                 "two_nn_blockmerge_bf16_two_launch",
                 "two_nn_ablation_two_launch_top1"])
LAUNCHES = {**{f"two_nn_oneblock_{d}_{tq}": 0 for d in DOTS
               for tq in ONEBLOCK_TILES},
            "two_nn_blockmerge_bf16": 0,
            **{f"two_nn_ablation_{m}": 0 for m in ABLATION_MODES},
            "two_nn_variants_prepass": 0,
            **dict.fromkeys(TWO_LAUNCH, 0),
            **{f"two_nn_oneblock_mma_{d}_{tq}": 0 for d in DOTS
               for tq in ONEBLOCK_TILES},
            "two_nn_blockmerge_bf16_mma": 0,
            **{f"two_nn_ablation_mma_{m}": 0 for m in ABLATION_MODES}}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(SOURCE))
        p, i = ctypes.c_void_p, ctypes.c_int
        head = [p, i, p, p, p, i]              # table, K, counts, pi, pj, B
        # table, tab16, n_img, K, counts, norms, qsq, two_launch, pi, pj, B
        ws = [p, p, i, i, p, p, p, i, p, p, i]
        tail = [p, p, p, p]                    # d0, i0, d1, stream
        for name, args in (
                ("two_nn_oneblock", ws + [i, i] + tail),
                ("two_nn_blockmerge_bf16", ws + tail),
                ("two_nn_ablation", ws + [i] + tail),
                ("two_nn_oneblock_mma", head + [i, i] + tail),
                ("two_nn_blockmerge_bf16_mma", head + tail),
                ("two_nn_ablation_mma", head + [i] + tail),
                ("two_nn_variants_prepass", [p, i, i, p, i, p, p, p, p])):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = args
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


def prepass_plain(table: torch.Tensor, counts: torch.Tensor, bf16: bool
                  ) -> Outputs:
    """The `wgmma` design's per-call pre-pass: int32 column constants
    [n_img, K] (|b|²·256 + row % 128, plus F32_MAGIC_BIAS wrapped to int32
    for the bf16 dot; KEY_POISON at or past the count), |q|² int32 [n_img,
    K], and for the bf16 dot the table as bf16 (else None)."""
    t = table.int()
    sq = (t * t).sum(-1)
    row = torch.arange(table.shape[1], device=table.device)
    c = sq.long() * 256 + row % NORM_TILE + (F32_MAGIC_BIAS if bf16 else 0)
    c = (c + 2 ** 31) % 2 ** 32 - 2 ** 31
    c = torch.where(row < counts[:, None].long(), c,
                    torch.full_like(c, KEY_POISON)).int()
    return c, sq.int(), table.to(torch.bfloat16) if bf16 else None


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


def _outputs(B: int, K: int, device, scratch: int = 0):
    """d0 f32, i0 int32, d1 f32 [B, K] and `scratch` int32 elements for
    the kernel: views of one allocation."""
    n = B * K
    buf = torch.empty(3 * n + scratch, dtype=torch.int32, device=device)
    return (buf[:n].view(torch.float32).view(B, K), buf[n:2 * n].view(B, K),
            buf[2 * n:3 * n].view(torch.float32).view(B, K), buf[3 * n:])


def _run(name: str, counter: str, plain: Callable[[], Outputs],
         launch: Callable, table, counts, pi, pj, row_multiple: int,
         scratch_per_row: int = 0) -> Outputs:
    """Checks, then the plain version for CPU tensors, or `launch(table,
    counts, pi, pj, (d0, i0, d1), scratch, stream)` for CUDA tensors
    (raising on a nonzero CUDA error), counted under `counter`; `scratch`
    holds `scratch_per_row` int32 per table row, allocated with the
    outputs."""
    _check(name, table, counts, pi, pj, row_multiple)
    if table.device.type == "cpu":
        return plain()
    table, counts = table.contiguous(), counts.contiguous()
    pi, pj = pi.contiguous(), pj.contiguous()
    B, (n_img, K) = pi.shape[0], table.shape[:2]
    *out, scratch = _outputs(B, K, table.device,
                             scratch_per_row * n_img * K if B else 0)
    if B == 0:
        return tuple(out)
    with torch.cuda.device(table.device):
        err = launch(table, counts, pi, pj, out, scratch,
                     torch.cuda.current_stream().cuda_stream)
    _launched(err, name, counter)
    return tuple(out)


def _launched(err: int, name: str, counter: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def variants_prepass(table: torch.Tensor, counts: torch.Tensor,
                     bf16: bool = False):
    """`prepass_plain` of a centered int8 table [n_img, K, 128] (K % 128
    == 0) and its int32 counts; on CUDA by the pre-pass kernel (count
    "two_nn_variants_prepass"): the two-launch yardsticks' first launch."""
    if table.device.type == "cpu":
        return prepass_plain(table, counts, bf16)
    _check_prepass("variants_prepass", table, counts)
    table, counts = table.contiguous(), counts.contiguous()
    norms = torch.empty(table.shape[:2], dtype=torch.int32,
                        device=table.device)
    qsq = torch.empty_like(norms)
    tab16 = _prepass(table, counts, norms, qsq, bf16)
    return norms, qsq, tab16


def bf16_table(table: torch.Tensor) -> torch.Tensor:
    """The bf16 copy of a centered int8 table [n_img, K, 128] (K % 128 ==
    0) that the bf16 dot's ring loads; on CUDA by the pre-pass kernel with
    the table alone (count "two_nn_variants_prepass").  Make it once per
    table and pass it to the bf16 variants as `table16`."""
    if table.device.type == "cpu":
        return table.to(torch.bfloat16)
    _check_prepass("bf16_table", table)
    return _prepass(table.contiguous(), None, None, None, True)


def _check_prepass(name, table, counts=None):
    if (table.device.type != "cuda" or table.dtype != torch.int8
            or table.dim() != 3 or table.shape[2] != 128
            or table.shape[1] % NORM_TILE
            or (counts is not None and (
                counts.device != table.device or counts.dtype != torch.int32
                or counts.shape != table.shape[:1]))):
        raise ValueError(f"{name}: need a CUDA int8 [n_img, K, 128] table "
                         "with K % 128 == 0 (and int32 [n_img] counts on the "
                         "same device)")


def _prepass(table, counts, norms, qsq, bf16):
    """Launch the pre-pass kernel; returns the bf16 table (bf16) or None."""
    n_img, K = table.shape[0], table.shape[1]
    tab16 = (torch.empty(table.shape, dtype=torch.bfloat16,
                         device=table.device) if bf16 else None)
    if table.numel():
        ptr = (lambda t: None if t is None else t.data_ptr())   # noqa: E731
        with torch.cuda.device(table.device):
            err = _load().two_nn_variants_prepass(
                table.data_ptr(), n_img, K, ptr(counts), int(bf16), ptr(norms),
                ptr(qsq), ptr(tab16), torch.cuda.current_stream().cuda_stream)
        _launched(err, "variants_prepass", "two_nn_variants_prepass")
    return tab16


def _ws_launch(entry: str, bf16: bool, *extra, two_launch: bool = False,
               table16=None):
    """The `wgmma` design's launch: one launch that writes the column
    constants and |q|² into the scratch (the bf16 dot reads `table16`,
    made here if not given), or with `two_launch` the pre-pass and the
    kernel reading its constants and |q|²."""
    def launch(table, counts, pi, pj, out, scratch, stream):
        norms = qsq = None
        tab16 = table16
        if two_launch:
            norms, qsq, tab16 = variants_prepass(table, counts, bf16)
        else:
            if scratch.numel():                 # not "matmul_max"
                norms, qsq = scratch.view(2, -1)
            if bf16 and tab16 is None:
                tab16 = bf16_table(table)
            elif bf16:
                _check_table16(table, tab16)
        ptr = (lambda t: None if t is None else t.data_ptr())   # noqa: E731
        return getattr(_load(), entry)(
            table.data_ptr(), ptr(tab16) if bf16 else None, table.shape[0],
            table.shape[1], counts.data_ptr(), ptr(norms), ptr(qsq),
            int(two_launch), pi.data_ptr(), pj.data_ptr(), pi.shape[0],
            *extra, *(o.data_ptr() for o in out), stream)
    return launch


def _check_table16(table, tab16):
    if (tab16.dtype != torch.bfloat16 or tab16.shape != table.shape
            or tab16.device != table.device or not tab16.is_contiguous()):
        raise ValueError("table16 must be bf16_table(table): a contiguous "
                         "bf16 tensor of the table's shape on its device")


def _mma_launch(entry: str, *extra):
    """The first design's launch."""
    def launch(table, counts, pi, pj, out, scratch, stream):
        return getattr(_load(), entry)(
            table.data_ptr(), table.shape[1], counts.data_ptr(),
            pi.data_ptr(), pj.data_ptr(), pi.shape[0], *extra,
            *(o.data_ptr() for o in out), stream)
    return launch


def _oneblock_args(tq: int, dot: str) -> None:
    if tq not in ONEBLOCK_TILES:
        raise ValueError(f"two_nn_oneblock: tq must be one of "
                         f"{ONEBLOCK_TILES}, got {tq}")
    if dot not in DOTS:
        raise ValueError(f"two_nn_oneblock: dot must be one of {DOTS}, "
                         f"got {dot!r}")


def two_nn_oneblock(table: torch.Tensor, counts: torch.Tensor,
                    pi: torch.Tensor, pj: torch.Tensor, tq: int = 128,
                    dot: str = "int8", table16=None) -> Outputs:
    """Exact 2-NN with a one-pass top-2 over each score row; tq query rows
    share each staged db tile (K % tq == 0); dot "int8" or "bf16".  On the
    `wgmma` design, one launch (bf16: `table16` = `bf16_table(table)`, made
    here if not given), except bf16 at tq > 128 (the `mma.sync` design)."""
    _oneblock_args(tq, dot)
    bf16 = dot == "bf16"
    launch = (_mma_launch("two_nn_oneblock_mma", tq, 1) if bf16 and tq > 128
              else _ws_launch("two_nn_oneblock", bf16, tq, int(bf16),
                              table16=table16))
    return _run("two_nn_oneblock", f"two_nn_oneblock_{dot}_{tq}",
                lambda: oneblock_plain(table, counts, pi, pj), launch,
                table, counts, pi, pj, tq, 0 if bf16 and tq > 128 else 2)


def two_nn_oneblock_two_launch(table: torch.Tensor, counts: torch.Tensor,
                               pi: torch.Tensor, pj: torch.Tensor,
                               tq: int = 128, dot: str = "int8") -> Outputs:
    """`two_nn_oneblock` on the `wgmma` design in its two-launch form (the
    pre-pass, then the kernel reading its constants and |q|²), for timing
    and checks beside the one-launch kernel; int8 at every tq, bf16 at
    tq 128."""
    _oneblock_args(tq, dot)
    if dot == "bf16" and tq > 128:
        raise ValueError("two_nn_oneblock_two_launch: bf16 runs on the "
                         "`wgmma` design at tq 128 only")
    return _run("two_nn_oneblock_two_launch",
                f"two_nn_oneblock_two_launch_{dot}_{tq}",
                lambda: oneblock_plain(table, counts, pi, pj),
                _ws_launch("two_nn_oneblock", dot == "bf16", tq,
                           int(dot == "bf16"), two_launch=True),
                table, counts, pi, pj, tq)


def two_nn_blockmerge_bf16(table: torch.Tensor, counts: torch.Tensor,
                           pi: torch.Tensor, pj: torch.Tensor,
                           table16=None) -> Outputs:
    """Exact 2-NN with a bf16 dot, 256 query rows per work item and the db
    in 512-row blocks folded into a running top-2 (K % 512 == 0); one
    launch (`table16` as for `two_nn_oneblock`)."""
    return _run("two_nn_blockmerge_bf16", "two_nn_blockmerge_bf16",
                lambda: blockmerge_plain(table, counts, pi, pj),
                _ws_launch("two_nn_blockmerge_bf16", True, table16=table16),
                table, counts, pi, pj, BLOCKMERGE_BD, 2)


def two_nn_blockmerge_bf16_two_launch(table: torch.Tensor,
                                      counts: torch.Tensor, pi: torch.Tensor,
                                      pj: torch.Tensor) -> Outputs:
    """`two_nn_blockmerge_bf16` in its two-launch form."""
    return _run("two_nn_blockmerge_bf16_two_launch",
                "two_nn_blockmerge_bf16_two_launch",
                lambda: blockmerge_plain(table, counts, pi, pj),
                _ws_launch("two_nn_blockmerge_bf16", True, two_launch=True),
                table, counts, pi, pj, BLOCKMERGE_BD)


def two_nn_oneblock_mma(table: torch.Tensor, counts: torch.Tensor,
                        pi: torch.Tensor, pj: torch.Tensor, tq: int = 128,
                        dot: str = "int8") -> Outputs:
    """`two_nn_oneblock` on the first design's `mma.sync` kernel, for
    timing and checks beside the `wgmma` design."""
    _oneblock_args(tq, dot)
    return _run("two_nn_oneblock_mma", f"two_nn_oneblock_mma_{dot}_{tq}",
                lambda: oneblock_plain(table, counts, pi, pj),
                _mma_launch("two_nn_oneblock_mma", tq, int(dot == "bf16")),
                table, counts, pi, pj, tq)


def two_nn_blockmerge_bf16_mma(table: torch.Tensor, counts: torch.Tensor,
                               pi: torch.Tensor, pj: torch.Tensor
                               ) -> Outputs:
    """`two_nn_blockmerge_bf16` on the first design's `mma.sync` kernel."""
    return _run("two_nn_blockmerge_bf16_mma", "two_nn_blockmerge_bf16_mma",
                lambda: blockmerge_plain(table, counts, pi, pj),
                _mma_launch("two_nn_blockmerge_bf16_mma"),
                table, counts, pi, pj, BLOCKMERGE_BD)


def _ablation_mode(mode: str) -> int:
    if mode not in ABLATION_MODES:
        raise ValueError(f"two_nn_ablation: unknown mode {mode!r}; "
                         f"expected one of {ABLATION_MODES}")
    return ABLATION_MODES.index(mode)


def two_nn_ablation(table: torch.Tensor, counts: torch.Tensor,
                    pi: torch.Tensor, pj: torch.Tensor, mode: str) -> Outputs:
    """Epilogue ablation (not a matcher), int8 dot, 128 query rows
    (K % 128 == 0): mode "matmul_max" or "top1", on the `wgmma` design,
    one launch."""
    m = _ablation_mode(mode)
    return _run("two_nn_ablation", f"two_nn_ablation_{mode}",
                lambda: ablation_plain(table, counts, pi, pj, mode),
                _ws_launch("two_nn_ablation", False, m),
                table, counts, pi, pj, ABLATION_TQ, 2 * m)


def two_nn_ablation_two_launch(table: torch.Tensor, counts: torch.Tensor,
                               pi: torch.Tensor, pj: torch.Tensor,
                               mode: str = "top1") -> Outputs:
    """`two_nn_ablation` in its two-launch form: "top1" only ("matmul_max"
    reads no constants)."""
    if mode != "top1":
        raise ValueError(f"two_nn_ablation_two_launch: mode must be 'top1', "
                         f"got {mode!r}")
    return _run("two_nn_ablation_two_launch",
                "two_nn_ablation_two_launch_top1",
                lambda: ablation_plain(table, counts, pi, pj, mode),
                _ws_launch("two_nn_ablation", False, 1, two_launch=True),
                table, counts, pi, pj, ABLATION_TQ)


def two_nn_ablation_mma(table: torch.Tensor, counts: torch.Tensor,
                        pi: torch.Tensor, pj: torch.Tensor, mode: str
                        ) -> Outputs:
    """`two_nn_ablation` on the first design's `mma.sync` kernel."""
    m = _ablation_mode(mode)
    return _run("two_nn_ablation_mma", f"two_nn_ablation_mma_{mode}",
                lambda: ablation_plain(table, counts, pi, pj, mode),
                _mma_launch("two_nn_ablation_mma", m),
                table, counts, pi, pj, ABLATION_TQ)
