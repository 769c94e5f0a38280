"""The port's `match_pairs_batched` against the JAX package's, on the CPU.

On the CPU the kernel wrapper (`matching_cuda.two_nn_pairs`) runs its
plain PyTorch version; the kernels are held against it on the card by
chip_smoke.py.  Tolerance: exact — the match dicts are identical to the
JAX package's, to `DescriptorTable.match_pairs` and to themselves under
another `block` or `batch`, on uint8 descriptors (centered int8 tables)
and on the same values as float32 (f32 tables: integer-valued, so the
kernel's bf16 operands are exact).  The assertions of
`tests/test_matching.py::test_match_pairs_batched` / `test_min_matches_cutoff`
run as port cases too.  `block` is the JAX signature's and has no
effect on the result.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.ops import matching as J
from bundler_sfm_tpu_torch.ops import matching as T
from tests.test_matching import brute_force_matches, make_descs


def collection(rng):
    """Six images sharing jittered descriptors, ragged counts up to 400,
    with repeated rows (many-to-one matches for the dedup), one image of
    one key and one of none."""
    base = make_descs(rng, 160)
    descs = [make_descs(rng, 100 + 60 * i, seed_descs=base, n_shared=90)
             for i in range(5)]
    descs[2][150:170] = descs[2][10:30]
    descs[4][300:305] = descs[0][:5]
    descs.append(descs[1][:1].copy())
    descs.append(np.zeros((0, 128), np.uint8))
    return descs


PAIRS = [(j, i) for i in range(7) for j in range(i)]


def same(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype == np.int32 and np.array_equal(a[k], b[k])
        for k in a)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_match_pairs_batched_matches_jax(rng, dtype):
    descs = [d.astype(dtype) for d in collection(rng)]
    for min_matches in (0, 16):
        want = J.match_pairs_batched(descs, PAIRS, batch=4, block=256,
                                     min_matches=min_matches)
        got = T.match_pairs_batched(descs, PAIRS, batch=4, block=256,
                                    min_matches=min_matches, device="cpu")
        assert same(got, want)
        table = T.DescriptorTable(descs, device="cpu").match_pairs(
            PAIRS, min_matches=min_matches)
        assert same(got, table)
    assert sum(len(m) for m in got.values()) > 300


def test_float_equals_uint8(rng):
    descs = collection(rng)
    u8 = T.match_pairs_batched(descs, PAIRS, device="cpu")
    f32 = T.match_pairs_batched([d.astype(np.float32) for d in descs], PAIRS,
                                device="cpu")
    assert same(u8, f32)


@pytest.mark.parametrize("block,batch", [(128, 1), (512, 7), (1024, 64),
                                         (100, 3)])
def test_independent_of_block_and_batch(rng, block, batch):
    """The db count masks the padding: the result does not depend on the
    padded width or on how the pairs are chunked."""
    descs = collection(rng)
    want = T.match_pairs_batched(descs, PAIRS, batch=32, block=1024,
                                 device="cpu")
    got = T.match_pairs_batched(descs, PAIRS, batch=batch, block=block,
                                device="cpu")
    assert same(got, want)


def test_one_kernel_call_per_chunk(rng, monkeypatch):
    """Each chunk of `batch` pairs is one two_nn_pairs call on one table of
    every image, padded as `DescriptorTable` pads it (int8 for uint8
    descriptors, f32 for float ones), as query table and db table both."""
    descs = collection(rng)
    calls = []
    real = T.two_nn_pairs

    def spy(qtab, dbtab, db_counts, pi, pj):
        calls.append((qtab.shape, qtab.dtype, dbtab is qtab, len(pi)))
        return real(qtab, dbtab, db_counts, pi, pj)
    monkeypatch.setattr(T, "two_nn_pairs", spy)
    T.match_pairs_batched(descs, PAIRS, batch=8, block=256, device="cpu")
    assert [c[3] for c in calls] == [8, 8, 5]
    assert all(c[:3] == ((7, 512, 128), torch.int8, True) for c in calls)
    calls.clear()
    T.match_pairs_batched([d.astype(np.float32) for d in descs], PAIRS[:3],
                          device="cpu")
    assert calls == [((7, 512, 128), torch.float32, True, 3)]


def test_against_brute_force(rng):
    """tests/test_matching.py: each list is the exact 2-NN ratio test,
    pruned keep-first; the min_matches cutoff drops pairs below it."""
    base = make_descs(rng, 120)
    descs = [make_descs(rng, 100 + 13 * i, seed_descs=base, n_shared=50)
             for i in range(4)]
    pairs = [(0, 1), (0, 2), (1, 2), (2, 3)]
    got = T.match_pairs_batched(descs, pairs, batch=3, block=256,
                                min_matches=0, device="cpu")
    for (i, j) in pairs:
        want = T.prune_double_matches(brute_force_matches(descs[i], descs[j]))
        assert np.array_equal(got[(i, j)], want), (i, j)
    rand = [make_descs(rng, 64), make_descs(rng, 64)]
    got = T.match_pairs_batched(rand, [(0, 1)], block=256, min_matches=16,
                                device="cpu")
    assert (0, 1) not in got or len(got[(0, 1)]) >= 16
    assert T.match_pairs_batched(rand, [], device="cpu") == {}
