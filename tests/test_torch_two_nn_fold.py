"""The int8 2-NN kernel's per-score arithmetic, emulated in PyTorch on the
CPU, against the plain version and the JAX package's `two_nn`.

`csrc/two_nn.cu` (the `wgmma` kernel) never forms distances per score.  It
packs key = c - 512·(q·b) with the column constant c = |b|²·256 + column
(`two_nn_norms_plain`), so key = (|b|² − 2q·b)·256 + column in int32; each
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


def _fold2(ka, kb, b0, b1):
    lo, hi = torch.minimum(ka, kb), torch.maximum(ka, kb)
    b1 = torch.minimum(torch.minimum(torch.maximum(b0, lo), b1), hi)
    return torch.minimum(b0, lo), b1


def emulate(q, db, count, rng):
    """(d0, i0, d1) of int8 query [Nq, 128] against the first `count` rows
    of int8 db [Nd, 128], by the kernel's arithmetic.  Products past Nd
    (rows of the next image, or TMA's zero fill) are random garbage."""
    nq = q.shape[0]
    norms = MC.two_nn_norms_plain(
        db[None], torch.tensor([count], dtype=torch.int32))[0].long()
    kp = norms.shape[0]
    acc = q.long() @ db.long().T
    garbage = torch.from_numpy(rng.integers(-2 ** 21, 2 ** 21 + 1,
                                            (nq, kp - db.shape[0])))
    acc = torch.cat([acc, garbage], 1)
    qsq = (q.long() ** 2).sum(-1)
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
