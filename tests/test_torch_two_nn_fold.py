"""The int8 2-NN kernel's per-score arithmetic, emulated in PyTorch on the
CPU, against the plain version and the JAX package's `two_nn`.

`csrc/two_nn.cu` (the `wgmma` kernel) never forms distances per score.  It
packs key = c - 512·(q·b) with the column constant c = |b|²·256 + column
(`two_nn_norms_plain`), so key = (|b|² − 2q·b)·256 + column in int32.  The
launch writes c itself: in a first phase every thread of the grid takes
16-byte units of the db table, eight lanes a row (dp4a, then an xor tree
over the eight), poisoning rows at or past the count; the grid then meets
at a barrier (one counter whose top bit flips when the last block
arrives) before the ring loads the constants.  The consumers take |q|² of
their rows from the A fragments they hold.  `prephase_constants`,
`grid_barrier` and `fragment_qsq` below follow those steps.  Each
thread folds its two columns of every 8-column group into a tile-local
top-2 of keys, merges that into a running (e0, i0, e1) once per 128-column
tile with the running entry winning ties, and adds |q|² back at the end,
after a merge across the four lanes that share a row.  Only a pair's last
tile can hold rows past the count; there keys of poisoned columns are
replaced by KEY_POISON.  The emulation below follows that order step by
step, so the bit budget (keys never leave int32), the tie order and the
poisoning are checked where no card is.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.ops import matching as J
from bundler_sfm_tpu_torch.ops import matching_cuda as MC

NT = MC.NORM_TILE
POISON = MC.KEY_POISON
E_POISON = POISON >> 8


def _wrap32(x):
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


PRE_UNROLL = 16         # units a thread loads before it uses any


def prephase_constants(table: torch.Tensor, counts, threads: int,
                       kp: int = None, bias: int = 0):
    """`table_constants` of wgmma_ring.cuh over a grid of `threads`
    threads (a multiple of 32): unit u = 8·row + part is the part-th 16
    bytes of row `row` of the table padded to kp rows an image; thread g
    takes units g + (k·PRE_UNROLL + i)·threads for rounds k and i <
    PRE_UNROLL; the eight lanes of a row (one warp, one round) sum their
    dp4a partials by an xor tree; c = s·256 + r % NT + bias wrapped to
    int32 below the count, KEY_POISON from there.  Returns int64 constants
    [n_img, kp] and |b|² [n_img, Nd]."""
    n_img, nd = table.shape[0], table.shape[1]
    kp = kp or nd
    units = n_img * kp * 8
    rounds = -(-units // (threads * PRE_UNROLL))
    u = torch.arange(threads)[:, None, None] + threads * (
        torch.arange(rounds)[None, :, None] * PRE_UNROLL
        + torch.arange(PRE_UNROLL)[None, None, :])
    u = u.flatten()
    u = u[u < units]
    # Every unit once, and a row's eight units on eight lanes of one warp.
    assert torch.equal(torch.sort(u).values, torch.arange(units))
    assert ((u % threads) % 32 // 8 == (u % 32) // 8).all()
    row, part = torch.arange(units) // 8, torch.arange(units) % 8
    j, r = row // kp, row % kp
    padded = torch.zeros((n_img, kp, 128), dtype=torch.long)
    padded[:, :nd] = table.long()
    partial = (padded.reshape(-1, 8, 16)[row, part] ** 2).sum(-1)
    lanes = partial.view(-1, 8)
    for mask in (1, 2, 4):                       # the xor tree
        lanes = lanes + lanes[:, torch.arange(8) ^ mask]
    s = lanes[:, 0]
    cnt = torch.as_tensor(counts).long()
    c = torch.where(r[::8] < cnt[j[::8]],
                    _wrap32(s * 256 + r[::8] % NT + bias), torch.tensor(POISON))
    return c.view(n_img, kp), s.view(n_img, kp)[:, :nd]


def grid_barrier(counter: int, grid: int, order) -> int:
    """`grid_barrier` of wgmma_ring.cuh on a uint32 counter: the blocks
    arrive in `order`; block 0 adds 2³¹ − (grid − 1), the others 1.
    Checks that the top bit flips exactly at the last arrival, and returns
    the counter after the barrier."""
    top = counter & 0x80000000
    for k, b in enumerate(order):
        counter = (counter + (0x80000000 - (grid - 1) if b == 0 else 1)
                   ) % 2 ** 32
        assert ((counter & 0x80000000) != top) == (k == grid - 1)
    return counter


def fragment_qsq(q_tile: torch.Tensor) -> torch.Tensor:
    """|q|² of the 128 rows of an int8 query tile as the consumers compute
    it from their A fragments (the m16n8k32 layout): thread (warpgroup wg,
    warp w, lane 4g + t) holds rows 64wg + 16w + g and that + 8; at k-step
    kk its two words of a row are bytes kk·32 + 4t.. and kk·32 + 16 + 4t..
    (dp4a each), then the four lanes t are summed (the xor shuffles).
    int64 [128]."""
    t = torch.arange(4)[:, None, None]
    kk = torch.arange(4)[None, :, None]
    j = torch.arange(8)[None, None, :]
    idx = kk * 32 + 4 * t + j % 4 + 16 * (j // 4)    # [lane, k-step, byte]
    # The lanes' words cover each byte of a row once, and the threads'
    # rows cover the tile once.
    assert sorted(idx.flatten().tolist()) == list(range(128))
    assert sorted(64 * wg + 16 * w + g + 8 * hi for wg in range(2)
                  for w in range(4) for g in range(8) for hi in (0, 1)
                  ) == list(range(128))
    return (q_tile.long()[:, idx] ** 2).sum(-1).sum(-1).sum(-1)


def _fold2(ka, kb, b0, b1):
    lo, hi = torch.minimum(ka, kb), torch.maximum(ka, kb)
    b1 = torch.minimum(torch.minimum(torch.maximum(b0, lo), b1), hi)
    return torch.minimum(b0, lo), b1


def emulate(q, db, count, rng):
    """(d0, i0, d1) of int8 query [Nq, 128] against the first `count` rows
    of int8 db [Nd, 128], by the kernel's arithmetic.  Products past Nd
    (rows of the next image, or TMA's zero fill) are random garbage."""
    nq = q.shape[0]
    # The constants the launch's first phase writes; they equal the
    # two-launch form's (the norms kernel's plain version).
    kp = -(-db.shape[0] // NT) * NT
    norms = prephase_constants(db[None], [count], 384, kp)[0][0]
    assert torch.equal(norms, MC.two_nn_norms_plain(
        db[None], torch.tensor([count], dtype=torch.int32))[0].long())
    acc = q.long() @ db.long().T
    garbage = torch.from_numpy(rng.integers(-2 ** 21, 2 ** 21 + 1,
                                            (nq, kp - db.shape[0])))
    acc = torch.cat([acc, garbage], 1)
    qsq = fragment_qsq(q)
    e0 = torch.full((nq, 4), E_POISON, dtype=torch.long)
    e1 = e0.clone()
    i0 = torch.zeros((nq, 4), dtype=torch.long)
    n_tiles = -(-count // NT)
    for n in range(n_tiles):
        c = norms[n * NT:(n + 1) * NT]
        raw = c - 512 * acc[:, n * NT:(n + 1) * NT]
        valid = (c != POISON).expand_as(raw)
        # The bit budget: a valid column's key never leaves int32.
        assert (raw[valid] >= -2 ** 31).all() and (raw[valid] < POISON).all()
        key = _wrap32(raw)
        if n == n_tiles - 1 and count % NT:
            key = torch.where(valid, key, POISON)
        # Lane t holds columns 8i + 2t and 8i + 2t + 1 of each group i.
        key = key.view(nq, NT // 8, 4, 2)
        b0 = torch.full((nq, 4), POISON, dtype=torch.long)
        b1 = b0.clone()
        for i in range(NT // 8):
            b0, b1 = _fold2(key[:, i, :, 0], key[:, i, :, 1], b0, b1)
        t0, t1 = b0 >> 8, b1 >> 8
        lt = t0 < e0
        e1 = torch.where(lt, torch.minimum(e0, t1), torch.minimum(e1, t0))
        i0 = torch.where(lt, n * NT + (b0 & 255), i0)
        e0 = torch.where(lt, t0, e0)
    for mask in (1, 2):
        perm = torch.arange(4) ^ mask
        o0, oi, o1 = e0[:, perm], i0[:, perm], e1[:, perm]
        other = (o0 < e0) | ((o0 == e0) & (oi < i0))
        n1 = torch.where(other, torch.minimum(e0, o1), torch.minimum(o0, e1))
        e0 = torch.where(other, o0, e0)
        i0 = torch.where(other, oi, i0)
        e1 = n1

    def dist(e):
        return torch.where(e[:, 0] >= E_POISON, torch.tensor(MC.BIG),
                           (qsq + e[:, 0]).float())
    return dist(e0), i0[:, 0].int(), dist(e1)


def _case(rng, kind):
    """(query, db, count) as centered int8, Nd a multiple of 64; rows past
    the count hold nonzero garbage."""
    q = rng.integers(-128, 128, (128, 128))
    db = rng.integers(-128, 128, (320, 128))
    count = 300
    if kind == "extreme_neg_pos":          # the largest |q.b| and |b|^2
        q[:], db[:] = -128, 127
        db[100:] = -128
    elif kind == "extreme_pos_neg":
        q[:64], q[64:], db[:] = 127, -128, -128
        db[5] = 127
    elif kind == "extreme_self":           # d = 0 at |q|^2 = 2^21
        q[:], db[:] = -128, -128
        count = 129
    elif kind == "ties":
        db[128:256] = db[0:128]            # equal rows one tile later
        db[299] = db[3]
        db[10:20] = db[9]
        q[:40] = db[:40]                   # exact hits
    elif kind == "one_repeated_row":
        db[:] = db[7]
    elif kind.startswith("count_"):
        count = int(kind[len("count_"):])
        q[:30] = db[:30]
    return (torch.from_numpy(q.astype(np.int8)),
            torch.from_numpy(db.astype(np.int8)), count)


KINDS = ["extreme_neg_pos", "extreme_pos_neg", "extreme_self", "ties",
         "one_repeated_row", "count_0", "count_1", "count_65", "count_128",
         "count_129", "count_256", "count_320"]


@pytest.mark.parametrize("kind", KINDS)
def test_fold_matches_reference_and_jax(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    q, db, count = _case(rng, kind)
    got = emulate(q, db, count, rng)
    want = MC.two_nn_reference(q, db, count)
    jax_out = J.two_nn(jnp.asarray(q.numpy()), jnp.asarray(db.numpy()),
                       jnp.int32(count), block=64)
    for g, w, j in zip(got, want, jax_out):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    if count == 0:
        assert not got[1].any()


def test_norms_plain_against_jax_norms(rng):
    """|b|² in the constant's high bits equals the JAX package's squared
    norms; the low bits are the column in its 128-row tile; rows at or
    past the count, and the padding to a multiple of 128, are poisoned."""
    tab = torch.from_numpy(rng.integers(-128, 128, (3, 192, 128)
                                        ).astype(np.int8))
    counts = torch.tensor([192, 130, 0], dtype=torch.int32)
    c = MC.two_nn_norms_plain(tab, counts)
    assert c.shape == (3, 256) and c.dtype == torch.int32
    for j in range(3):
        n = int(counts[j])
        x = jnp.asarray(tab[j, :n].numpy()).astype(jnp.int32)
        want = np.asarray(jnp.sum(x * x, axis=-1))
        np.testing.assert_array_equal((c[j, :n] >> 8).numpy(), want)
        np.testing.assert_array_equal((c[j, :n] & 255).numpy(),
                                      np.arange(n) % NT)
        assert (c[j, n:] == POISON).all()


def test_product_max_plain(rng):
    """The product-only ablation's plain version: the row max of q·b over
    the valid db rows, −3e38 where there is none, i0 = d1 = 0."""
    tab = torch.from_numpy(rng.integers(-128, 128, (3, 192, 128)
                                        ).astype(np.int8))
    counts = torch.tensor([192, 70, 0], dtype=torch.int32)
    pi = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    pj = torch.tensor([1, 0, 1, 2], dtype=torch.int32)
    d0, i0, d1 = MC.product_max_plain(tab, tab, counts, pi, pj)
    t = tab.numpy().astype(np.int64)
    for b in range(3):
        n = int(counts[pj[b]])
        want = (t[pi[b]] @ t[pj[b], :n].T).max(1)
        np.testing.assert_array_equal(d0[b].numpy(), want.astype(np.float32))
    assert (d0[3] == -MC.BIG).all() and not i0.any() and not d1.any()


@pytest.mark.parametrize("threads", [384, 3 * 384, 132 * 384])
@pytest.mark.parametrize("nd,counts", [
    (320, [320, 300, 129, 128, 65, 1, 0]),
    (192, [192, 130, 127, 0]),
    (256, [256, 255, 1]),
])
def test_prephase_constants_match_norms_plain_and_jax(nd, counts, threads):
    """The launch's first phase over grids of 1, 3 and 132 blocks, garbage
    in the rows past every count and Nd not a multiple of 128: every
    constant equal to `two_nn_norms_plain` (the two-launch form's), with
    |b|² in the high bits equal to the JAX package's squared norms."""
    rng = np.random.default_rng(nd)
    tab = torch.from_numpy(rng.integers(-128, 128, (len(counts), nd, 128)
                                        ).astype(np.int8))
    tab[0, 0] = -128                       # the largest |b|²
    c = torch.tensor(counts, dtype=torch.int32)
    kp = -(-nd // NT) * NT
    got, sq = prephase_constants(tab, c, threads, kp)
    assert torch.equal(got, MC.two_nn_norms_plain(tab, c).long())
    x = jnp.asarray(tab.numpy()).astype(jnp.int32)
    np.testing.assert_array_equal(sq.numpy(),
                                  np.asarray(jnp.sum(x * x, axis=-1)))


def test_grid_barrier_needs_no_reset(rng):
    """Launches of different grid sizes, blocks arriving in any order, on
    one counter: each barrier opens exactly at its last arrival and adds
    2³¹ in all, so the next launch finds the counter as it needs it."""
    counter = 0
    for grid in (1, 2, 7, 132, 5, 132):
        after = grid_barrier(counter, grid, rng.permutation(grid))
        assert after == (counter + 2 ** 31) % 2 ** 32
        counter = after


def test_fragment_qsq_matches_jax(rng):
    """|q|² from the A fragments (the m16n8k32 layout, four lanes a row)
    equals the JAX package's squared norms, the extremes included."""
    q = torch.from_numpy(rng.integers(-128, 128, (128, 128)).astype(np.int8))
    q[0], q[1], q[127] = -128, 127, 0
    x = jnp.asarray(q.numpy()).astype(jnp.int32)
    np.testing.assert_array_equal(fragment_qsq(q).numpy(),
                                  np.asarray(jnp.sum(x * x, axis=-1)))
