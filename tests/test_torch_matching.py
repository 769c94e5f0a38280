"""The port's exact 2-NN matcher against the JAX package's, on the CPU.

On the CPU the kernel wrapper runs its plain PyTorch version; the kernel
itself is held against that version on the card by chip_smoke.py.
Tolerance: exact — i0 and d0 bit-identical, d1 bit-identical (3e38 where
fewer than two db rows are valid), match dicts identical.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.ops import matching as J
from bundler_sfm_tpu.ops.matching_pallas import two_nn_pallas
from bundler_sfm_tpu_torch.ops import matching as T
from bundler_sfm_tpu_torch.ops import matching_cuda as TC


def make_descs(rng, n, seed_descs=None, n_shared=0, noise=4):
    d = rng.integers(0, 256, (n, 128)).astype(np.uint8)
    if seed_descs is not None and n_shared:
        base = seed_descs[:n_shared].astype(np.int32)
        jit = rng.integers(-noise, noise + 1, base.shape)
        d[:n_shared] = np.clip(base + jit, 0, 255).astype(np.uint8)
    return d


# (dtype, Nq, Nd, db_count, duplicated db rows) — the shapes of
# tests/test_matching.py and tests/test_pallas_kernel.py plus edge cases.
CASES = [
    ("int8", 256, 512, 490, False),
    ("int8", 256, 1536, 1400, True),
    ("int8", 256, 512, 1, False),
    ("int8", 256, 512, 0, False),
    ("f32", 512, 1024, 900, False),
    ("f32", 256, 1536, 1200, True),
    ("f32", 256, 512, 1, True),
]


def _inputs(rng, dtype, nq, nd, dup):
    q = rng.integers(0, 256, (nq, 128))
    db = rng.integers(0, 256, (nd, 128))
    if dup:
        db[300:400] = db[0:100]          # equal rows at higher indices
        db[nd - 1] = db[3]
        db[0] = db[1]
        q[:50] = db[:50]                 # exact hits: distance 0 ties
    if dtype == "int8":
        return J._prep_desc(q.astype(np.uint8)), J._prep_desc(db.astype(np.uint8))
    return q.astype(np.float32), db.astype(np.float32)


@pytest.mark.parametrize("dtype,nq,nd,count,dup", CASES)
def test_two_nn_matches_jax(rng, dtype, nq, nd, count, dup):
    q, db = _inputs(rng, dtype, nq, nd, dup)
    want = [np.asarray(x) for x in J.two_nn(
        jnp.asarray(q), jnp.asarray(db), jnp.int32(count), block=512)]
    got = [x.numpy() for x in T.two_nn(torch.from_numpy(q),
                                       torch.from_numpy(db), count)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    if count < 2:
        assert (got[2] == np.float32(3e38)).all()


@pytest.mark.parametrize("dtype,nq,nd,count,dup",
                         [CASES[1], CASES[2], CASES[5]])
def test_two_nn_matches_pallas_interpret(rng, dtype, nq, nd, count, dup):
    """Against the TPU kernel itself, run in Pallas interpret mode."""
    q, db = _inputs(rng, dtype, nq, nd, dup)
    want = [np.asarray(x) for x in two_nn_pallas(
        jnp.asarray(q), jnp.asarray(db), jnp.int32(count), interpret=True)]
    got = [x.numpy() for x in T.two_nn(torch.from_numpy(q),
                                       torch.from_numpy(db), count)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_two_nn_pairs_plain_batches_like_per_pair(rng):
    """The wrapper's batched plain path equals two_nn_reference per pair."""
    tab = torch.from_numpy(J._prep_desc(
        rng.integers(0, 256, (3, 256, 128)).astype(np.uint8)))
    counts = torch.tensor([256, 100, 1], dtype=torch.int32)
    pi = torch.tensor([0, 1, 2, 0, 2], dtype=torch.int32)
    pj = torch.tensor([1, 2, 0, 0, 2], dtype=torch.int32)
    d0, i0, d1 = TC._two_nn_pairs_plain(tab, tab, counts, pi, pj,
                                        chunk_elems=3 * 256 * 256)
    for b in range(len(pi)):
        r = TC.two_nn_reference(tab[pi[b]], tab[pj[b]], counts[pj[b]])
        for x, y in zip((d0[b], i0[b], d1[b]), r):
            assert torch.equal(x, y)


@pytest.mark.parametrize("min_matches", [0, 16])
def test_descriptor_table_match_dicts(rng, min_matches):
    base = make_descs(rng, 300)
    descs = [make_descs(rng, 180 + 41 * i, seed_descs=base, n_shared=150)
             for i in range(5)]
    descs[2][10] = descs[2][20]              # many-to-one claims
    descs[3][:5] = descs[3][5]
    descs.append(np.zeros((0, 128), np.uint8))
    pairs = [(j, i) for i in range(6) for j in range(i)]
    want = J.DescriptorTable(descs).match_pairs(pairs,
                                                min_matches=min_matches)
    got = T.DescriptorTable(descs, device="cpu").match_pairs(
        pairs, batch=4, min_matches=min_matches)
    assert want.keys() == got.keys() and len(got) > 0
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])


def test_descriptor_table_float_descriptors(rng):
    descs = [rng.integers(0, 256, (n, 128)).astype(np.float32)
             for n in (200, 150, 90)]
    descs[1][:60] = descs[0][:60] + rng.integers(-3, 4, (60, 128))
    pairs = [(0, 1), (0, 2), (1, 2)]
    want = J.DescriptorTable(descs).match_pairs(pairs)
    got = T.DescriptorTable(descs, device="cpu").match_pairs(pairs)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])


def test_match_pair_matches_jax(rng):
    d2 = make_descs(rng, 200)
    d1 = make_descs(rng, 150, seed_descs=d2, n_shared=60)
    want = J.match_pair(d1, d2)
    got = T.match_pair(d1, d2, device="cpu")
    np.testing.assert_array_equal(want, got)
    assert len(got) > 40


def test_prune_and_symmetrize_match_jax():
    m = np.array([[0, 5], [1, 7], [2, 5], [3, 9], [4, 7]], dtype=np.int32)
    np.testing.assert_array_equal(J.prune_double_matches(m),
                                  T.prune_double_matches(m))
    d = {(0, 1): m, (1, 3): m[:2]}
    js, ts = J.symmetrize(d), T.symmetrize(d)
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k])


def _bad_pairs_call(what):
    """A call of the pair wrappers' checks with one bad input.  The wrappers
    run them on CUDA tensors before any launch (on the CPU they take the
    plain path, which accepts any shape); CPU tensors pass the device
    check, so the messages are held here."""
    tab = torch.zeros((2, 256, 128), dtype=torch.int8)
    c = torch.tensor([256, 256], dtype=torch.int32)
    p = torch.zeros(1, dtype=torch.int32)
    dt = (torch.int8, torch.float32)
    check = TC._check_tables
    return {
        "nq": (lambda: check(tab[:, :200], tab, c, p, p, dt), "Nq % 128"),
        "nd": (lambda: check(tab, tab[:, :100], c, p, p, dt), "Nd % 64"),
        "dtype": (lambda: check(tab, tab.float(), c, p, p, dt),
                  "both be int8 or f32"),
        "int8_only": (lambda: check(tab.float(), tab.float(), c, p, p,
                                    (torch.int8,)), "both be int8,"),
        "dim": (lambda: check(tab[..., :64], tab[..., :64], c, p, p, dt),
                "128 elements"),
        "index": (lambda: check(tab, tab, c, p, p + 2, dt), "out of range"),
        "count": (lambda: check(tab, tab, c + 1, p, p, dt), "out of range"),
        "index_dtype": (lambda: check(tab, tab, c, p.long(), p, dt),
                        "must be int32"),
        "pair_shape": (lambda: check(tab, tab, c, p, torch.zeros(
            2, dtype=torch.int32), dt), "pi, pj must be"),
        "device": (lambda: TC.two_nn_pairs(*(t.to("meta") for t in (
            tab, tab, c, p, p))), "unsupported device"),
    }[what]


@pytest.mark.parametrize("what", ["nq", "nd", "dtype", "int8_only", "dim",
                                  "index", "count", "index_dtype",
                                  "pair_shape", "device"])
def test_two_nn_pairs_checks_reject_bad_inputs(what):
    fn, msg = _bad_pairs_call(what)
    with pytest.raises(ValueError, match=msg):
        fn()
