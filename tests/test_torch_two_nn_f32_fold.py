"""The f32 2-NN kernel's per-score arithmetic (`csrc/two_nn.cu`,
`two_nn_f32_ws_kernel`), emulated in PyTorch on the CPU, against the plain
version (`two_nn_reference`) and the JAX package's `two_nn`.

The pre-pass (`prepass_f32_plain`) writes bf16 copies of the tables, |q|²
and |b|² of the unrounded f32 values (3e38 at or past the count).  The
tensor cores sum bf16 products in f32.  Every score's distance is formed as
the plain version forms it, d = (|q|² + |b|²) − 2·acc: one FADD and one
FFMA, which rounds as the subtraction does because 2·acc is exact.  Lane t
of a row group holds columns 8i + 2t and 8i + 2t + 1 of each 128-column
tile and folds them in order into a tile-local f32 top-2 (a strict `<`,
so the lowest column wins ties); once per tile that merges into the
running (e0, i0, e1), the running entry winning ties.  In a pair's last
tile the columns at or past the count are 3e38, whatever the rows there
hold; the four lanes of a row merge at the end, ties to the lower index.

Tolerance: exact on integer-valued tables with |x| ≤ 255, 0 and 255
included: every product and partial sum is an integer below 2²⁴, so the
order of the sums does not matter.  On real-valued tables the CPU's matrix
product stands in for the tensor cores (whose order of summation differs
again) and the norms are summed in the pre-pass's order, so there the
emulation is held to `matching_cuda.f32_tolerance`: |Δd| ≤ 1e-5·(|q|² +
|b|²), i0 equal wherever the plain version's d1 − d0 exceeds twice that.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.ops import matching as J
from bundler_sfm_tpu_torch.ops import matching_cuda as MC

NT = MC.NORM_TILE
BIG = torch.tensor(MC.BIG, dtype=torch.float32)


def emulate(q, db, count, rng):
    """(d0, i0, d1) of f32 query [Nq, 128] against the first `count` rows of
    f32 db [Nd, 128], by the kernel's arithmetic.  Products past Nd (rows
    of the next image, or TMA's zero fill) are random garbage."""
    nq = q.shape[0]
    q16, qsq, _ = MC.prepass_f32_plain(q[None])
    db16, _, bsq = MC.prepass_f32_plain(
        db[None], torch.tensor([count], dtype=torch.int32))
    bsq, qsq = bsq[0], qsq[0]
    acc = q16[0].float() @ db16[0].float().T
    garbage = torch.from_numpy(rng.normal(0, 1e6, (nq, bsq.shape[0]
                                                   - db.shape[0]))).float()
    acc = torch.cat([acc, garbage], 1)
    e0 = torch.full((nq, 4), MC.BIG)
    e1 = e0.clone()
    i0 = torch.zeros((nq, 4), dtype=torch.long)
    t = torch.arange(4)
    for n in range(-(-count // NT)):
        # FADD, then FFMA: 2·acc is exact, so this is one rounding too.
        d = (qsq[:, None] + bsq[None, n * NT:(n + 1) * NT]) \
            - 2.0 * acc[:, n * NT:(n + 1) * NT]
        valid = count - n * NT
        if valid < NT:
            d[:, valid:] = BIG
        d = d.view(nq, NT // 8, 4, 2)
        b0 = torch.full((nq, 4), MC.BIG)
        b1 = b0.clone()
        k0 = torch.zeros((nq, 4), dtype=torch.long)
        for i in range(NT // 8):
            for j in range(2):
                x = d[:, i, :, j]
                k0 = torch.where(x < b0, 8 * i + 2 * t + j, k0)
                b1 = torch.minimum(b1, torch.maximum(b0, x))
                b0 = torch.minimum(b0, x)
        lt = b0 < e0
        e1 = torch.where(lt, torch.minimum(e0, b1), torch.minimum(e1, b0))
        i0 = torch.where(lt, n * NT + k0, i0)
        e0 = torch.where(lt, b0, e0)
    for mask in (1, 2):
        perm = t ^ mask
        o0, oi, o1 = e0[:, perm], i0[:, perm], e1[:, perm]
        other = (o0 < e0) | ((o0 == e0) & (oi < i0))
        n1 = torch.where(other, torch.minimum(e0, o1), torch.minimum(o0, e1))
        e0 = torch.where(other, o0, e0)
        i0 = torch.where(other, oi, i0)
        e1 = n1
    return e0[:, 0], i0[:, 0].int(), e1[:, 0]


def _case(rng, kind):
    """(query, db, count) as f32, Nd a multiple of 64; rows past the count
    hold nonzero garbage."""
    real = kind.startswith("real")
    if real:
        q = rng.normal(size=(128, 128))
        db = rng.normal(size=(320, 128))
        db[:60] = q[:60] + 0.05 * rng.normal(size=(60, 128))
        q = 512 * q / np.linalg.norm(q, axis=1, keepdims=True)
        db = 512 * db / np.linalg.norm(db, axis=1, keepdims=True)
    else:
        q = rng.integers(0, 256, (128, 128)).astype(np.float64)
        db = rng.integers(0, 256, (320, 128)).astype(np.float64)
    count = 300
    if kind == "extreme_255_0":            # the largest q·b and |b|²
        q[:], db[:] = 255, 0
        db[100:200] = 255
    elif kind == "extreme_0_255":
        q[:64], q[64:], db[:] = 0, 255, 255
        db[5] = 0
    elif kind == "extreme_self":           # d = 0 at |q|² = 128·255²
        q[:], db[:] = 255, 255
        count = 129
    elif kind == "ties":
        db[128:256] = db[0:128]            # equal rows one tile later
        db[299] = db[3]
        db[10:20] = db[9]
        q[:40] = db[:40]                   # exact hits
    elif kind == "one_repeated_row":
        db[:] = db[7]
    elif kind.startswith("count_"):
        count = int(kind.split("_")[1])
        q[:30] = db[:30]
    db[count:] = rng.integers(1, 256, db[count:].shape) * 1000.0
    return (torch.from_numpy(q.astype(np.float32)),
            torch.from_numpy(db.astype(np.float32)), count)


EXACT = ["extreme_255_0", "extreme_0_255", "extreme_self", "ties",
         "one_repeated_row", "count_0", "count_1", "count_65", "count_128",
         "count_129", "count_256", "count_320"]
REAL = ["real", "real_count_129"]


def _jax(q, db, count):
    return [np.asarray(x) for x in J.two_nn(
        jnp.asarray(q.numpy()), jnp.asarray(db.numpy()), jnp.int32(count),
        block=64)]


@pytest.mark.parametrize("kind", EXACT)
def test_fold_matches_reference_and_jax(kind):
    rng = np.random.default_rng(EXACT.index(kind))
    q, db, count = _case(rng, kind)
    got = emulate(q, db, count, rng)
    want = MC.two_nn_reference(q, db, count)
    for g, w, j in zip(got, want, _jax(q, db, count)):
        assert torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), j)
    if count == 0:
        assert not got[1].any()
    if count < 2:
        assert (got[2] == BIG).all()


@pytest.mark.parametrize("kind", REAL)
def test_fold_real_valued_within_tolerance(kind):
    rng = np.random.default_rng(100 + REAL.index(kind))
    q, db, count = _case(rng, kind)
    if kind == "real_count_129":
        count = 129
    got = emulate(q, db, count, rng)
    counts = torch.tensor([count], dtype=torch.int32)
    p = torch.zeros(1, dtype=torch.int32)
    tol = MC.f32_tolerance(q[None], db[None], counts, p, p)[0]
    want = MC.two_nn_reference(q, db, count)
    jax_out = [torch.tensor(x) for x in _jax(q, db, count)]
    for ref in (want, jax_out):
        bad = MC.f32_mismatches([g[None] for g in got],
                                [r[None] for r in ref], tol[None])
        assert bad == [0, 0, 0]
    # The tolerance is not vacuous: the near-duplicates are separated.
    assert ((want[2] - want[0]) > 2 * tol).sum() >= 50


@pytest.mark.parametrize("with_counts", [True, False])
def test_prepass_f32_plain(with_counts):
    """The bf16 copy, |x|² from the unrounded values (exact for integers;
    within f32 rounding of the f64 sum for real values) and the column
    norms, 3e38 at or past the count and in the padding to 128 rows."""
    rng = np.random.default_rng(7)
    ints = rng.integers(0, 256, (2, 192, 128)).astype(np.float32)
    real = (rng.normal(size=(2, 192, 128)) * 300).astype(np.float32)
    counts = torch.tensor([192, 70], dtype=torch.int32)
    for tab, exact in ((ints, True), (real, False)):
        t = torch.from_numpy(tab)
        t16, sq, bsq = MC.prepass_f32_plain(t, counts if with_counts else None)
        assert t16.dtype == torch.bfloat16 and sq.dtype == torch.float32
        assert torch.equal(t16, t.to(torch.bfloat16))
        want = (tab.astype(np.float64) ** 2).sum(-1)
        if exact:
            np.testing.assert_array_equal(sq.numpy(), want)
        else:
            np.testing.assert_allclose(sq.numpy(), want, rtol=1e-6)
        if not with_counts:
            assert bsq is None
            continue
        assert bsq.shape == (2, 256)
        for j, n in enumerate(counts.tolist()):
            assert torch.equal(bsq[j, :n], sq[j, :n])
            assert (bsq[j, n:] == BIG).all()


def test_product_max_plain_f32():
    """The f32 product-only split's plain version rounds the operands to
    bf16 as the kernel does: exact row max of q·b for integer values."""
    rng = np.random.default_rng(8)
    tab = torch.from_numpy(rng.integers(0, 256, (3, 192, 128)
                                        ).astype(np.float32))
    tab[0, :5] = 255.0
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
