"""The `wgmma` design of the 2-NN probe variants (`csrc/two_nn_variants.cu`,
`variant_ws_kernel`): its per-score arithmetic emulated in PyTorch on the
CPU, against the plain versions (`oneblock_plain`, `blockmerge_plain`) and
the JAX package's composition of the probe's kernels (`_tile_top2`,
`_merge_top2`).

The kernel never forms distances per score.  The launch's first phase
(`prephase_constants`, the arithmetic of `prepass_plain`, the two-launch
form's pre-pass) gives every db row the column constant c = |b|²·256 +
row % 128 (KEY_POISON at or past the count) and every row |q|²; with the
bf16 dot, c also carries F32_MAGIC_BIAS and the accumulator, an f32 sum of
bf16 products, becomes an int32 by reading acc + 1.5·2²³ as an int32
(acc + 0x4B400000).  key = c − 512·acc wraps to (|b|² − 2q·b)·256 + column.
Work items are tq query rows; each of two consumer warpgroups owns tq/128
m64 tiles, whose rows come from the query tile in shared memory (tq ≥ 256)
or from registers (tq 128).  Every thread folds its two columns of each
8-column group of a 128-column db tile into a tile-local top-2 of keys and
merges it into a running (e0, i0, e1), the running entry winning ties; with
blockmerge the tiles merge into a 512-row block state that folds into the
running one at each block boundary.  Only a pair's last tile holds rows past
the count; there keys of poisoned columns are raised to KEY_POISON.  The
four lanes of a row are merged at the end and |q|² is added back.

The ablations run the same kernel at tq 128 with the int8 dot.  "top1"
keeps one running key a row: each thread folds the keys of its columns into
a tile-local minimum (one IMAD and one min a score) and merges it into the
running (e0, i0) once per tile, ties keeping the running entry; counts 0
and 1 give i0 = 0 and 3e38 from KEY_POISON as the top-2 kernels do.
"matmul_max" takes one max a score of the int32 accumulators over every
tile of the db image, the rows past the count included and none poisoned,
as the TPU kernel does; it reads no pre-pass.
Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.ops import matching_variants as V
from bundler_sfm_tpu_torch.ops.matching_cuda import BIG, KEY_POISON
from tests.test_torch_two_nn_fold import prephase_constants
from tests.test_torch_variants import _jax_pairs

NT = 128
E_POISON = KEY_POISON >> 8
MAGIC = 12582912.0                     # 1.5 * 2^23


def _wrap32(x):
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def acc_bits(acc: torch.Tensor) -> torch.Tensor:
    """The kernel's `acc_bits`: an int32 sum as it is, an f32 sum as the
    bits of acc + 1.5·2²³ (one FADD, round to nearest)."""
    if acc.dtype == torch.float32:
        return (acc + torch.tensor(MAGIC, dtype=torch.float32)
                ).view(torch.int32).long()
    return acc.long()


def _fold2(ka, kb, b0, b1):
    lo, hi = torch.minimum(ka, kb), torch.maximum(ka, kb)
    b1 = torch.minimum(torch.minimum(torch.maximum(b0, lo), b1), hi)
    return torch.minimum(b0, lo), b1


def _merge(e0, i0, e1, t0, ti, t1):
    """merge_tile / fold_running: fold (t0, ti, t1) into (e0, i0, e1); ties
    keep the running entry."""
    lt = t0 < e0
    return (torch.where(lt, t0, e0), torch.where(lt, ti, i0),
            torch.where(lt, torch.minimum(e0, t1), torch.minimum(e1, t0)))


def _pair_state(keys, count, merge):
    """Per-lane running (e0, i0, e1) [rows, 4] of one pair's query rows
    from their keys [rows, K] (int64, already wrapped), by the kernel's
    order: tile by tile, lane t holding columns 8i + 2t, 8i + 2t + 1."""
    rows = keys.shape[0]
    full = lambda v: torch.full((rows, 4), v, dtype=torch.long)  # noqa: E731
    e0, i0, e1 = full(E_POISON), full(0), full(E_POISON)
    f0, fi, f1 = full(E_POISON), full(0), full(E_POISON)
    n_tiles = -(-count // NT)
    for n in range(n_tiles):
        key = keys[:, n * NT:(n + 1) * NT]
        key = key.view(rows, NT // 8, 4, 2)
        b0, b1 = full(KEY_POISON), full(KEY_POISON)
        for i in range(NT // 8):
            b0, b1 = _fold2(key[:, i, :, 0], key[:, i, :, 1], b0, b1)
        tile = (b0 >> 8, n * NT + (b0 & 255), b1 >> 8)
        if merge:
            f0, fi, f1 = _merge(f0, fi, f1, *tile)
            if n == n_tiles - 1 or n % (V.BLOCKMERGE_BD // NT) == 3:
                e0, i0, e1 = _merge(e0, i0, e1, f0, fi, f1)
                f0, fi, f1 = full(E_POISON), full(0), full(E_POISON)
        else:
            e0, i0, e1 = _merge(e0, i0, e1, *tile)
    for mask in (1, 2):
        perm = torch.arange(4) ^ mask
        o0, oi, o1 = e0[:, perm], i0[:, perm], e1[:, perm]
        other = (o0 < e0) | ((o0 == e0) & (oi < i0))
        n1 = torch.where(other, torch.minimum(e0, o1), torch.minimum(o0, e1))
        e0 = torch.where(other, o0, e0)
        i0 = torch.where(other, oi, i0)
        e1 = n1
    return e0[:, 0], i0[:, 0], e1[:, 0]


def _a_rows(tq, bf16):
    """Query-tile rows of each (warpgroup, m-tile) as the kernel addresses
    them: registers at tq 128 (warpgroup wg holds rows 64·wg...), else the
    m64 tile of a shared-memory descriptor at byte offset (gm // 2)·TILE +
    (gm % 2)·8192 in 128-row boxes of 128-byte rows (two boxes a row block
    for bf16)."""
    mt_per_wg = tq // 128
    box = 128 * NT
    tile = (2 if bf16 else 1) * box
    rows = {}
    for wg in range(2):
        for mt in range(mt_per_wg):
            gm = wg * mt_per_wg + mt
            if tq == 128:
                first = wg * 64
            else:
                off = (gm // 2) * tile + (gm % 2) * 8192
                first = (off // tile) * NT + (off % box) // 128
            rows[(wg, mt)] = first
    return rows


def _prephase(table, counts, bf16, threads=3 * 384):
    """The constants and |q|² the launch's first phase writes (over a grid
    of `threads` threads), held equal to the two-launch form's pre-pass,
    and the bf16 table the bf16 dot's ring loads."""
    norms, qsq, tab16 = V.prepass_plain(table, counts, bf16)
    c, sq = prephase_constants(table, counts, threads,
                               bias=V.F32_MAGIC_BIAS if bf16 else 0)
    assert torch.equal(c, norms.long()) and torch.equal(sq, qsq.long())
    return c, sq, tab16


def emulate(table, counts, pi, pj, tq, dot, merge=False):
    """(d0, i0, d1) [B, K] of a `wgmma` instantiation by its arithmetic."""
    bf16 = dot == "bf16"
    norms, qsq, tab16 = _prephase(table, counts, bf16)
    K = table.shape[1]
    a_rows = _a_rows(tq, bf16)
    out = [torch.zeros((len(pi), K)), torch.zeros((len(pi), K),
                                                  dtype=torch.int32),
           torch.zeros((len(pi), K))]
    written = torch.zeros((len(pi), K), dtype=torch.int32)
    for b, (qi, dj) in enumerate(zip(pi.tolist(), pj.tolist())):
        if bf16:
            # bf16 operands, f32 sums: exact, every partial sum an integer
            # below 2^24 (TF32 plays no part on the CPU).
            acc = tab16[qi].float() @ tab16[dj].float().T
        else:
            acc = table[qi].long() @ table[dj].long().T
        bits = acc_bits(acc)
        c = norms[dj].long()
        raw = c - 512 * bits
        key = _wrap32(raw)
        valid = (c != KEY_POISON).expand_as(key)
        # The bit budget: a valid column's key never leaves int32 unwrapped
        # (int8), or lands where the wrapped offset cancels (bf16).
        unb = _wrap32(c - (V.F32_MAGIC_BIAS if bf16 else 0)) - 512 * acc.long()
        assert torch.equal(key[valid], unb[valid])
        assert (unb[valid] >= -2 ** 31).all() and (unb[valid] < KEY_POISON).all()
        count = int(counts[dj])
        last = -(-count // NT) - 1
        if count % NT:
            cols = slice(last * NT, (last + 1) * NT)
            key[:, cols] = torch.where(valid[:, cols], key[:, cols],
                                       torch.tensor(KEY_POISON))
        e0, i0, e1 = _pair_state(key, count, merge)
        for q0 in range(0, K, tq):
            for (wg, mt), first in a_rows.items():
                for warp in range(4):
                    for g in range(8):
                        for h in range(2):
                            out_row = q0 + (wg * (tq // 128) + mt) * 64 \
                                + warp * 16 + g + 8 * h
                            a_row = q0 + first + warp * 16 + g + 8 * h
                            assert a_row == out_row
                            written[b, out_row] += 1
        qs = qsq[qi].long()
        for k, e in ((0, e0), (2, e1)):
            out[k][b] = torch.where(e >= E_POISON, torch.tensor(BIG),
                                    (qs + e).float())
        out[1][b] = i0.int()
    assert (written == 1).all()
    return tuple(out)


def _lane_merge(e0, i0, mask):
    """(e0, i0) of lane ^ mask merged in; ties go to the lower index."""
    perm = torch.arange(4) ^ mask
    o0, oi = e0[:, perm], i0[:, perm]
    other = (o0 < e0) | ((o0 == e0) & (oi < i0))
    return torch.where(other, o0, e0), torch.where(other, oi, i0)


def emulate_ablation(table, counts, pi, pj, mode):
    """(d0, i0, d1) [B, K] of an ablation on the `wgmma` design by its
    arithmetic: per-thread column pairs of every 128-column tile, a
    tile-local fold, a once-per-tile merge, then the lane merge."""
    K = table.shape[1]
    if mode == "top1":
        norms, qsq, _ = _prephase(table, counts, False)
    out = [torch.zeros((len(pi), K)), torch.zeros((len(pi), K),
                                                  dtype=torch.int32),
           torch.zeros((len(pi), K))]
    full = lambda v: torch.full((K, 4), v, dtype=torch.long)  # noqa: E731
    for b, (qi, dj) in enumerate(zip(pi.tolist(), pj.tolist())):
        acc = table[qi].long() @ table[dj].long().T
        if mode == "matmul_max":
            m = full(-2 ** 31)
            for n in range(K // NT):           # every tile, whatever the count
                a = acc[:, n * NT:(n + 1) * NT].view(K, NT // 8, 4, 2)
                for i in range(NT // 8):
                    m = torch.maximum(m, torch.maximum(a[:, i, :, 0],
                                                       a[:, i, :, 1]))
            for mask in (1, 2):
                m = torch.maximum(m, m[:, torch.arange(4) ^ mask])
            out[0][b] = m[:, 0].float()
            continue
        c = norms[dj].long()
        key = _wrap32(c - 512 * acc)
        count = int(counts[dj])
        n_tiles = -(-count // NT)
        if count % NT:
            cols = slice((n_tiles - 1) * NT, n_tiles * NT)
            key[:, cols] = torch.where((c[cols] != KEY_POISON).expand(K, -1),
                                       key[:, cols], torch.tensor(KEY_POISON))
        e0, i0 = full(E_POISON), full(0)
        for n in range(n_tiles):
            k = key[:, n * NT:(n + 1) * NT].view(K, NT // 8, 4, 2)
            b0 = full(KEY_POISON)
            for i in range(NT // 8):
                b0 = torch.minimum(b0, torch.minimum(k[:, i, :, 0],
                                                     k[:, i, :, 1]))
            lt = (b0 >> 8) < e0
            e0 = torch.where(lt, b0 >> 8, e0)
            i0 = torch.where(lt, n * NT + (b0 & 255), i0)
        for mask in (1, 2):
            e0, i0 = _lane_merge(e0, i0, mask)
        qs = qsq[qi].long()
        out[0][b] = torch.where(e0[:, 0] >= E_POISON, torch.tensor(BIG),
                                (qs + e0[:, 0]).float())
        out[1][b] = i0[:, 0].int()
    return tuple(out)


def _table(K, counts, seed):
    """Centered int8 [5, K, 128]: duplicated db rows (ties), a db of one
    repeated row, query rows equal to db rows (distance-0 hits), extreme
    rows, and nonzero garbage in every row past its count."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(-128, 128, (len(counts), K, 128))
    tab[0, K // 2:K // 2 + 40] = tab[0, 0:40]
    tab[0, K - 1] = tab[0, 3]
    tab[1, :] = tab[1, 7]
    tab[2, :30] = tab[0, 100:130]
    tab[3, :8] = -128
    tab[3, 8:12] = 127
    return (torch.from_numpy(tab.astype(np.int8)),
            torch.tensor(counts, dtype=torch.int32))


TABLES = {"ragged": (1024, [1024, 1023, 65, 1, 0]),
          "tiles": (1024, [513, 512, 129, 128, 1000])}
PAIRS = [(0, 0), (0, 1), (1, 0), (2, 0), (0, 2), (3, 3), (2, 4), (4, 3),
         (1, 1), (3, 0)]
INSTANTIATIONS = ([(tq, "int8", False) for tq in V.ONEBLOCK_TILES]
                  + [(128, "bf16", False), (V.BLOCKMERGE_TQ, "bf16", True)])


def _ids(inst):
    tq, dot, merge = inst
    return "blockmerge_bf16" if merge else f"oneblock_{dot}_{tq}"


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("inst", INSTANTIATIONS, ids=_ids)
def test_emulation_matches_plain_and_jax(inst, name):
    tq, dot, merge = inst
    K, counts = TABLES[name]
    tab, cnt = _table(K, counts, sorted(TABLES).index(name))
    p = torch.tensor(PAIRS, dtype=torch.int32)
    pi, pj = p[:, 0].contiguous(), p[:, 1].contiguous()
    got = emulate(tab, cnt, pi, pj, tq, dot, merge)
    plain = (V.blockmerge_plain if merge else V.oneblock_plain)(
        tab, cnt, pi, pj)
    jax_out = _jax_pairs("blockmerge" if merge else "oneblock", tab.numpy(),
                         cnt.numpy(), PAIRS)
    for g, w, j in zip(got, plain, jax_out):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), j)
    n = cnt[pj.long()]
    assert (got[2][n < 2] == BIG).all() and not got[1][n == 0].any()


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("mode", V.ABLATION_MODES)
def test_ablation_emulation_matches_plain_and_jax(mode, name):
    """Both ablation modes on the `wgmma` design, emulated: bit-exact
    against `ablation_plain` and the JAX composition, on ragged counts (0
    and 1 included), ties and garbage rows past the counts."""
    K, counts = TABLES[name]
    tab, cnt = _table(K, counts, sorted(TABLES).index(name))
    p = torch.tensor(PAIRS, dtype=torch.int32)
    pi, pj = p[:, 0].contiguous(), p[:, 1].contiguous()
    got = emulate_ablation(tab, cnt, pi, pj, mode)
    plain = V.ablation_plain(tab, cnt, pi, pj, mode)
    jax_out = _jax_pairs(mode, tab.numpy(), cnt.numpy(), PAIRS)
    for g, w, j in zip(got, plain, jax_out):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), j)
    n = cnt[pj.long()]
    if mode == "top1":
        assert (got[0][n == 0] == BIG).all() and not got[1][n == 0].any()
        assert not got[2].any()
    else:
        # Rows past the count take part: the garbage there sets some maxima.
        valid = torch.stack([
            (tab[i].long() @ tab[j, :max(int(cnt[j]), 1)].long().T).amax(1)
            for i, j in PAIRS]).float()
        assert (got[0] != valid)[n < K].any()
        assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("extreme", [-(2 ** 21), -(2 ** 21) + 1, -1, 0, 1,
                                     2 ** 21 - 1, 2 ** 21])
def test_acc_bits_exact_at_the_bounds(extreme):
    """acc + 1.5·2²³ stays in [2²³, 2²⁴) for |q·b| ≤ 2²¹, so its bits are
    acc + 0x4B400000 exactly, and 512·0x4B400000 wraps to the bias."""
    acc = torch.tensor([float(extreme)], dtype=torch.float32)
    assert int(acc_bits(acc)) == extreme + 0x4B400000
    assert (512 * 0x4B400000) % 2 ** 32 == V.F32_MAGIC_BIAS
    c = 12345 * 256 + 77
    assert _wrap32(c + V.F32_MAGIC_BIAS - 512 * int(acc_bits(acc))) == \
        c - 512 * extreme


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_prepass_plain(bf16):
    """Column constants (|b|² in the high bits, the column in its 128-row
    tile in the low ones, the bf16 offset on top), KEY_POISON past the
    count, |q|² of every row (past the count too), the exact bf16 table."""
    tab, cnt = _table(256, [256, 200, 1, 0, 130], 7)
    c, qsq, t16 = V.prepass_plain(tab, cnt, bf16)
    sq = (tab.long() ** 2).sum(-1)
    assert c.dtype == qsq.dtype == torch.int32
    assert torch.equal(qsq.long(), sq)
    for j, n in enumerate(cnt.tolist()):
        unb = _wrap32(c[j, :n].long() - (V.F32_MAGIC_BIAS if bf16 else 0))
        assert torch.equal(unb >> 8, sq[j, :n])
        assert torch.equal(unb & 255, torch.arange(n) % NT)
        assert (c[j, n:] == KEY_POISON).all()
        assert not (c[j, :n] == KEY_POISON).any()
    assert (t16 is None) != bf16
    if bf16:
        assert t16.dtype == torch.bfloat16 and torch.equal(t16.float(),
                                                           tab.float())


@pytest.mark.parametrize("threads", [384, 132 * 384])
@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_prephase_matches_prepass_plain_and_jax(bf16, threads):
    """The launch's first phase: column constants (with the bf16 offset)
    and |q|² of every row equal to the two-launch form's pre-pass
    (`prepass_plain`), |q|² and the constants' high bits to the JAX
    package's squared norms, garbage past the counts poisoned."""
    tab, cnt = _table(256, [256, 200, 1, 0, 130], 7)
    c, sq, _ = _prephase(tab, cnt, bf16, threads)
    x = jnp.asarray(tab.numpy()).astype(jnp.int32)
    want = np.asarray(jnp.sum(x * x, axis=-1))
    np.testing.assert_array_equal(sq.numpy(), want)
    unb = _wrap32(c - (V.F32_MAGIC_BIAS if bf16 else 0))
    for j, n in enumerate(cnt.tolist()):
        np.testing.assert_array_equal((unb[j, :n] >> 8).numpy(), want[j, :n])
        assert (c[j, n:] == KEY_POISON).all()
