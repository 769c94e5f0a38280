"""Tests of the port that need an NVIDIA GPU: the hand-written kernels
against their plain PyTorch versions, and CUDA runs of the stages against
their CPU runs.  They skip on a host without CUDA.  On the card (which has
no JAX, so the repository's conftest is left out):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

This file imports nothing of JAX or of the JAX package.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io

import numpy as np
import pytest
import torch

from bundler_sfm_tpu_torch.ops import matching_cuda as MC
from bundler_sfm_tpu_torch.ops import matching_variants as MV
from bundler_sfm_tpu_torch.ops.matching import DescriptorTable

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _table(rng, sizes, dtype, K):
    tab = np.zeros((len(sizes), K, 128), np.float32)
    for i, n in enumerate(sizes):
        tab[i, :n] = rng.integers(0, 256, (n, 128))
    tab[0, 300:400] = tab[0, 0:100]                 # duplicated rows: ties
    tab[1, :] = tab[1, 5]                           # one repeated row
    if dtype == torch.int8:
        tab = tab - 128
    return torch.from_numpy(tab).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32],
                         ids=["int8", "f32"])
def test_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    sizes = [1024, 1024, 700, 65, 1, 0]
    tab = _table(rng, sizes, dtype, 1024).to(cuda)
    counts = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    n = len(sizes)
    pi = torch.arange(n, dtype=torch.int32, device=cuda).repeat_interleave(n)
    pj = torch.arange(n, dtype=torch.int32, device=cuda).repeat(n)
    key = "two_nn" if dtype == torch.int8 else "two_nn_f32"
    before = dict(MC.LAUNCHES)
    got = MC.two_nn_pairs(tab, tab, counts, pi, pj)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in MC.LAUNCHES.items()
             if v != before[k]}
    # int8: one launch (the kernel writes its own column constants); f32:
    # the pre-pass and the kernel.
    assert moved == ({key: 1} if dtype == torch.int8
                     else {key: 1, "two_nn_f32_prepass": 1})
    want = MC._two_nn_pairs_plain(tab, tab, counts, pi, pj)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _all_pairs(n, device):
    idx = torch.arange(n, dtype=torch.int32, device=device)
    return idx.repeat_interleave(n), idx.repeat(n)


def _mismatches(got, want):
    return [int((g != w).sum()) for g, w in zip(got, want)]


def _hold_int8(tab, counts, pi, pj, want=None):
    """The wgmma kernel, one launch, bit-exact against the plain version
    (or `want`)."""
    want = want or MC._two_nn_pairs_plain(tab, tab, counts, pi, pj)
    launches = dict(MC.LAUNCHES)
    got = MC.two_nn_pairs(tab, tab, counts, pi, pj)
    torch.cuda.synchronize()
    moved = {k: v - launches[k] for k, v in MC.LAUNCHES.items()
             if v != launches[k]}
    assert moved == {"two_nn": 1}
    assert _mismatches(got, want) == [0, 0, 0], "wgmma vs plain"


def test_extreme_descriptors(cuda):
    """The largest |q.b| either way: all -128 against all +127 and the
    reverse, and each against itself (the largest |e| the key holds)."""
    tab = torch.empty((4, 256, 128), dtype=torch.int8)
    tab[0], tab[1] = -128, 127
    tab[2, :128], tab[2, 128:] = -128, 127
    tab[3, :128], tab[3, 128:] = 127, -128
    tab[3, 200] = 0
    counts = torch.tensor([256, 256, 256, 201], dtype=torch.int32)
    pi, pj = _all_pairs(4, cuda)
    _hold_int8(tab.to(cuda), counts.to(cuda), pi, pj)


def test_ragged_counts_4096(cuda):
    """K = 4096 with counts that are not a multiple of the 128-row tile."""
    rng = np.random.default_rng(5)
    sizes = [4096, 4000, 3001, 65, 1, 0]
    tab = _table(rng, sizes, torch.int8, 4096)
    tab[2, :1000] = tab[0, 2000:3000]                # exact hits
    pi, pj = _all_pairs(len(sizes), cuda)
    _hold_int8(tab.to(cuda), torch.tensor(sizes, dtype=torch.int32,
                                          device=cuda), pi, pj)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32],
                         ids=["int8", "f32"])
def test_garbage_rows_past_count(cuda, dtype):
    """Rows past the count hold nonzero garbage, a count of 0 included:
    the kernel bit-exact against the plain version, which masks them, and
    i0 = 0, d0 = d1 = 3e38 where the db has no valid row."""
    rng = np.random.default_rng(6)
    sizes = [512, 300, 129, 1, 0, 0]
    tab = _table(rng, sizes, dtype, 512)
    for j, n in enumerate(sizes):
        junk = rng.integers(1, 128, (512 - n, 128)) * rng.choice([-1, 1])
        tab[j, n:] = torch.from_numpy(junk).to(dtype)
    tab = tab.to(cuda)
    counts = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    pi, pj = _all_pairs(len(sizes), cuda)
    want = MC._two_nn_pairs_plain(tab, tab, counts, pi, pj)
    empty = pj >= 4
    assert not want[1][empty].any() and (want[0][empty] == MC.BIG).all()
    got = MC.two_nn_pairs(tab, tab, counts, pi, pj)
    torch.cuda.synchronize()
    bad = _mismatches(got, want)
    assert bad == [0, 0, 0], f"mismatches d0, i0, d1 {bad}"


def test_ties_and_repeated_rows(cuda):
    """Duplicated db rows at higher indices, a db of one repeated row, and
    rows equal across 128-row tile boundaries."""
    rng = np.random.default_rng(7)
    tab = _table(rng, [1024, 1024, 1024, 1024], torch.int8, 1024)
    tab[2, 128:256] = tab[2, 0:128]
    tab[2, 1023] = tab[2, 127]
    tab[3, 500:1024] = tab[0, 0:524]
    pi, pj = _all_pairs(4, cuda)
    _hold_int8(tab.to(cuda), torch.tensor([1024, 1024, 1000, 1024],
                                          dtype=torch.int32, device=cuda),
               pi, pj)


def test_many_waves(cuda):
    """More work items (pair x 128 query rows) than the persistent grid has
    blocks, in a random pair order with repeats."""
    rng = np.random.default_rng(8)
    sizes = [512, 500, 384, 200, 511, 1, 0, 512]
    tab = _table(rng, sizes, torch.int8, 512)
    p = torch.from_numpy(rng.integers(0, len(sizes), (2, 700))
                         .astype(np.int32))
    _hold_int8(tab.to(cuda), torch.tensor(sizes, dtype=torch.int32,
                                          device=cuda),
               p[0].contiguous().to(cuda), p[1].contiguous().to(cuda))


def test_product_max_matches_plain(cuda):
    """The wgmma kernel's product-only ablation against its plain version:
    ragged counts (0 included), extreme rows, more items than blocks."""
    rng = np.random.default_rng(9)
    sizes = [1024, 1000, 129, 1, 0]
    tab = _table(rng, sizes, torch.int8, 1024)
    tab[2, :64] = -128
    tab[3, 0] = 127
    tab, counts = tab.to(cuda), torch.tensor(sizes, dtype=torch.int32,
                                             device=cuda)
    pi, pj = _all_pairs(len(sizes), cuda)
    before = dict(MC.LAUNCHES)
    got = MC.two_nn_product_max(tab, tab, counts, pi, pj)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in MC.LAUNCHES.items()
             if v != before[k]}
    assert moved == {"two_nn_product_max": 1}
    want = MC.product_max_plain(tab, tab, counts, pi, pj)
    assert _mismatches(got, want) == [0, 0, 0]


def _f32_case(kind):
    """(qtab, dbtab, counts) of integer-valued f32 descriptors in [0, 255]
    (every quantity exact in f32): the extremes 0 and 255, ragged counts
    4096 / 3001 / 65 / 1 / 0, ties, garbage past the counts, and a query
    table that is not the db table."""
    rng = np.random.default_rng(11)
    if kind == "extremes":
        tab = np.zeros((4, 256, 128), np.float32)
        tab[1] = 255
        tab[2, :128], tab[2, 128:] = 255, 0
        tab[3, ::2] = rng.integers(0, 256, (128, 128))
        sizes = [256, 256, 200, 129]
    elif kind == "ragged":
        sizes = [4096, 3001, 65, 1, 0]
        tab = _table(rng, sizes, torch.float32, 4096).numpy()
        tab[1, :2000] = tab[0, 1000:3000]
    elif kind == "ties":
        sizes = [1024, 1024, 1000, 1024]
        tab = _table(rng, sizes, torch.float32, 1024).numpy()
        tab[2, 128:256] = tab[2, 0:128]
        tab[2, 999] = tab[2, 127]
        tab[3, 500:1024] = tab[0, 0:524]
    else:                                    # garbage, separate
        sizes = [512, 300, 129, 1, 0, 0]
        tab = rng.integers(0, 256, (6, 512, 128)).astype(np.float32)
        tab[1, 200:300] = tab[0, 0:100]
    tab = torch.from_numpy(tab)
    counts = torch.tensor(sizes, dtype=torch.int32)
    qtab = tab
    if kind == "separate":
        qtab = torch.from_numpy(rng.integers(0, 256, (3, 256, 128))
                                .astype(np.float32))
        qtab[0, :100] = tab[0, :100]
    return qtab, tab, counts


@pytest.mark.parametrize("kind", ["extremes", "ragged", "ties", "garbage",
                                  "separate"])
def test_f32_kernel_bit_exact(cuda, kind):
    """The f32 `wgmma` kernel bit-exact against the plain version on
    integer-valued tables; one pre-pass launch when the query table is the
    db table, two otherwise."""
    qtab, dbtab, counts = _f32_case(kind)
    shared = qtab is dbtab
    dbtab, counts = dbtab.to(cuda), counts.to(cuda)
    qtab = dbtab if shared else qtab.to(cuda)
    nq, nd = qtab.shape[0], dbtab.shape[0]
    pi = torch.arange(nq, dtype=torch.int32, device=cuda).repeat_interleave(nd)
    pj = torch.arange(nd, dtype=torch.int32, device=cuda).repeat(nq)
    want = MC._two_nn_pairs_plain(qtab, dbtab, counts, pi, pj)
    before = dict(MC.LAUNCHES)
    got = MC.two_nn_pairs(qtab, dbtab, counts, pi, pj)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in MC.LAUNCHES.items()
             if v != before[k]}
    assert moved == {"two_nn_f32": 1,
                     "two_nn_f32_prepass": 2 if kind == "separate" else 1}
    assert _mismatches(got, want) == [0, 0, 0], "wgmma vs plain"
    assert not got[1][counts[pj.long()] == 0].any()


def test_f32_real_valued_within_tolerance(cuda):
    """Real-valued tables (L2-normalised Gaussian rows scaled to 512,
    noisy near-duplicates): the f32 kernel within MC.f32_tolerance of the
    plain version."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 1024, 128))
    x[1, :500] = x[0, :500] + 0.05 * rng.normal(size=(500, 128))
    x[2, :300] = x[0, 200:500] + 0.3 * rng.normal(size=(300, 128))
    x = 512 * x / np.linalg.norm(x, axis=-1, keepdims=True)
    tab = torch.from_numpy(x.astype(np.float32)).to(cuda)
    counts = torch.tensor([1024, 900, 513, 1], dtype=torch.int32, device=cuda)
    pi, pj = _all_pairs(4, cuda)
    want = MC._two_nn_pairs_plain(tab, tab, counts, pi, pj)
    tol = MC.f32_tolerance(tab, tab, counts, pi, pj)
    got = MC.two_nn_pairs(tab, tab, counts, pi, pj)
    torch.cuda.synchronize()
    assert MC.f32_mismatches(got, want, tol) == [0, 0, 0]


def test_f32_prepass_matches_plain(cuda):
    """The f32 pre-pass kernel bit-exact against its plain version on a
    real-valued table (the sums run in the same order), with and without
    counts, at a row count that is not a multiple of 128."""
    rng = np.random.default_rng(13)
    tab = torch.from_numpy(rng.normal(size=(3, 320, 128)).astype(np.float32)
                           * 100).to(cuda)
    counts = torch.tensor([320, 130, 0], dtype=torch.int32, device=cuda)
    for c in (counts, None):
        got = MC.prepass_f32(tab, c)
        torch.cuda.synchronize()
        want = MC.prepass_f32_plain(tab, c)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)


def test_product_max_f32_matches_plain(cuda):
    """The f32 kernel's product-only split against its plain version."""
    qtab, dbtab, counts = _f32_case("garbage")
    tab, counts = dbtab.to(cuda), counts.to(cuda)
    pi, pj = _all_pairs(tab.shape[0], cuda)
    before = MC.LAUNCHES["two_nn_product_max_f32"]
    got = MC.two_nn_product_max(tab, tab, counts, pi, pj)
    torch.cuda.synchronize()
    assert MC.LAUNCHES["two_nn_product_max_f32"] == before + 1
    want = MC.product_max_plain(tab, tab, counts, pi, pj)
    assert _mismatches(got, want) == [0, 0, 0]


def test_kernel_rejects_bad_inputs(cuda):
    tab = torch.zeros((2, 128, 128), dtype=torch.int8, device=cuda)
    counts = torch.tensor([128, 128], dtype=torch.int32, device=cuda)
    p = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="Nq % 128"):
        MC.two_nn_pairs(tab[:, :100], tab, counts, p, p)
    with pytest.raises(ValueError, match="both be int8 or f32"):
        MC.two_nn_pairs(tab, tab.float(), counts, p, p)
    with pytest.raises(ValueError, match="out of range"):
        MC.two_nn_pairs(tab, tab, counts, p, p + 2)
    with pytest.raises(ValueError, match="out of range"):
        MC.two_nn_pairs(tab, tab, counts + 1, p, p)


VARIANTS = ([("oneblock", dict(tq=tq, dot=dot)) for dot in MV.DOTS
             for tq in MV.ONEBLOCK_TILES]
            + [("blockmerge", {})]
            + [("ablation", dict(mode=m)) for m in MV.ABLATION_MODES])


def _variant(kind, kw):
    """The wrapper of one variant, its launch counter and its plain
    version."""
    if kind == "oneblock":
        return (lambda *a: MV.two_nn_oneblock(*a, **kw),
                f"two_nn_oneblock_{kw['dot']}_{kw['tq']}", MV.oneblock_plain)
    if kind == "blockmerge":
        return (MV.two_nn_blockmerge_bf16, "two_nn_blockmerge_bf16",
                MV.blockmerge_plain)
    return (lambda *a: MV.two_nn_ablation(*a, **kw),
            f"two_nn_ablation_{kw['mode']}",
            lambda *a: MV.ablation_plain(*a, **kw))


def _variant_table(cuda, garbage):
    """6 images x 1024 keys, ragged counts (65, 1, 0 included), duplicated
    rows (ties), one repeated row, exact hits; with `garbage`, random
    nonzero rows past every count."""
    rng = np.random.default_rng(2)
    sizes = [1024, 1000, 700, 65, 1, 0]
    tab = _table(rng, sizes, torch.int8, 1024)
    tab[2, :40] = tab[0, 10:50]                     # distance-0 hits
    if garbage:
        junk = torch.from_numpy(rng.integers(-128, 128, tab.shape)
                                .astype(np.int8))
        row = torch.arange(1024)[None, :, None]
        tab = torch.where(row >= torch.tensor(sizes)[:, None, None], junk, tab)
        tab[1, 600:1000] = tab[0, 0:400]
    n = len(sizes)
    pi = torch.arange(n, dtype=torch.int32).repeat_interleave(n)
    pj = torch.arange(n, dtype=torch.int32).repeat(n)
    return (tab.to(cuda), torch.tensor(sizes, dtype=torch.int32, device=cuda),
            pi.to(cuda), pj.to(cuda))


@pytest.mark.parametrize("garbage", [False, True], ids=["zeros", "garbage"])
@pytest.mark.parametrize("kind,kw", VARIANTS,
                         ids=[f"{k}-{'-'.join(map(str, kw.values()))}"
                              for k, kw in VARIANTS])
def test_variant_kernel_matches_plain(cuda, kind, kw, garbage):
    """Each variant kernel, one launch (a bf16 one also makes the table's
    bf16 copy, one pre-pass launch), bit-exact against its plain version
    and the exact ones against `two_nn_pairs`: ragged counts, duplicated
    rows (ties), one repeated row, exact hits, and with `garbage` random
    rows past every count."""
    tab, counts, pi, pj = _variant_table(cuda, garbage)
    fn, counter, plain = _variant(kind, kw)
    before = dict(MV.LAUNCHES)
    got = fn(tab, counts, pi, pj)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in MV.LAUNCHES.items() if v != before[k]}
    expect = {counter: 1}
    if "bf16" in counter:
        expect["two_nn_variants_prepass"] = 1
    assert moved == expect
    for g, w in zip(got, plain(tab, counts, pi, pj)):
        assert torch.equal(g, w)
    if kind != "ablation":
        for g, w in zip(got, MC.two_nn_pairs(tab, tab, counts, pi, pj)):
            assert torch.equal(g, w)
    if counter != "two_nn_ablation_matmul_max":
        assert not got[1][pj == 5].any()            # no valid db row: i0 = 0


@pytest.mark.parametrize("dot", MV.DOTS)
def test_oneblock_layout(cuda, dot):
    """One CTA a work item but for the bf16 dot above 256 rows, which runs
    on clusters of tq/256 CTAs of 256 query rows; every layout fits one
    CTA's 227 KB of shared memory and has at least one cluster resident."""
    for tq in MV.ONEBLOCK_TILES:
        lay = MV.oneblock_layout(tq, dot)
        assert lay["cluster"] == (tq // 256 if dot == "bf16" and tq > 256
                                  else 1)
        assert 0 < lay["smem"] <= 232448 and lay["resident"] > 0


def test_bf16_table_matches_plain(cuda):
    """The pre-pass kernel, one launch: the table's bf16 copy
    (`bf16_table`) equal to its plain version."""
    tab, _, _, _ = _variant_table(cuda, garbage=True)
    before = MV.LAUNCHES["two_nn_variants_prepass"]
    got = MV.bf16_table(tab)
    torch.cuda.synchronize()
    assert MV.LAUNCHES["two_nn_variants_prepass"] == before + 1
    assert torch.equal(got, tab.to(torch.bfloat16))


def test_variant_wrappers_reject_bad_inputs(cuda):
    tab = torch.zeros((2, 256, 128), dtype=torch.int8, device=cuda)
    c = torch.tensor([256, 256], dtype=torch.int32, device=cuda)
    p = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="centered int8"):
        MV.two_nn_oneblock(tab.float(), c, p, p)
    with pytest.raises(ValueError, match="K % 512"):
        MV.two_nn_oneblock(tab, c, p, p, tq=512)
    with pytest.raises(ValueError, match="K % 512"):
        MV.two_nn_blockmerge_bf16(tab, c, p, p)
    with pytest.raises(ValueError, match="unknown mode"):
        MV.two_nn_ablation(tab, c, p, p, "top2")
    with pytest.raises(ValueError, match="out of range"):
        MV.two_nn_oneblock(tab, c, p, p + 2)
    with pytest.raises(ValueError, match="out of range"):
        MV.two_nn_ablation(tab, c + 1, p, p, "top1")
    with pytest.raises(ValueError, match="table on"):
        MV.two_nn_oneblock(tab, c.cpu(), p, p)


def test_descriptor_table_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (600, 128))
    descs = []
    for n in (600, 550, 480, 300):
        d = np.clip(base[:n] + rng.integers(-5, 6, (n, 128)), 0, 255)
        descs.append(d[rng.permutation(n)].astype(np.uint8))
    pairs = [(j, i) for i in range(4) for j in range(i)]
    want = DescriptorTable(descs, device="cpu").match_pairs(pairs)
    got = DescriptorTable(descs, device=cuda).match_pairs(pairs)
    assert want.keys() == got.keys() and len(got) == len(pairs)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k])


def test_sift_cuda_agrees_with_cpu(cuda):
    from bundler_sfm_tpu_torch.features.sift import extract_sift
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:160, 0:160]
    img = np.full((160, 160), 40.0)
    for _ in range(14):
        cx, cy, s = rng.uniform(30, 130), rng.uniform(30, 130), rng.uniform(3, 6)
        img += 180.0 * np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s))
    img = np.clip(img, 0, 255)
    ci, cd = extract_sift(img, max_keys_total=512, device="cpu")
    gi, gd = extract_sift(img, max_keys_total=512, device=cuda)
    assert len(ci) > 10 and abs(len(gi) - len(ci)) <= 0.01 * len(ci) + 1
    hits = 0
    for k in range(len(ci)):
        near = np.nonzero(np.abs(gi - ci[k]).max(1) <= 1e-3)[0]
        if len(near):
            hits += 1
            assert np.abs(gd[near].astype(int) - cd[k].astype(int)).max(1).min() <= 1
    assert hits >= 0.97 * len(ci)


def _ba_problem(device, C=5, P=300, seed=0):
    from tests.synthetic import Scene, random_rotation
    from bundler_sfm_tpu_torch.convert import ba_problem_from_numpy
    rng = np.random.default_rng(seed)
    sc = Scene(rng, num_cams=C, num_pts=P, noise=0.4, k1=-0.03)
    R0 = np.stack([random_rotation(rng, 0.02) @ sc.R[i] for i in range(C)])
    cam0 = np.zeros((C, 9))
    cam0[:, 0:3] = sc.centers + rng.normal(size=(C, 3)) * 0.02
    cam0[:, 6] = sc.f
    keep = rng.random((C, P)) < 0.8
    oc, op = np.nonzero(keep)
    oxy = np.stack([sc.obs[c][p] for c, p in zip(oc, op)])
    pts0 = sc.points + rng.normal(size=sc.points.shape) * 0.03
    return ba_problem_from_numpy(R0, cam0, pts0, oc, op, oxy,
                                 device=device)


@pytest.mark.parametrize("max_iters", [8, 150])
def test_run_ba_cuda_matches_cpu(cuda, max_iters):
    """f64 BA on the card against the CPU from the same problem: cameras
    and points within 1e-9 of the largest entry (capped: same count)."""
    from bundler_sfm_tpu_torch.ops import ba as T
    from bundler_sfm_tpu_torch.utils import get_telemetry
    before = get_telemetry().counters.get("ba_runs_cuda", 0)
    g = T.run_ba(_ba_problem(cuda), max_iters=max_iters)
    c = T.run_ba(_ba_problem("cpu"), max_iters=max_iters)
    assert get_telemetry().counters["ba_runs_cuda"] == before + 1
    if max_iters == 8:
        assert g.iters == c.iters == 8
    for a, b in ((g.cam, c.cam), (g.R, c.R), (g.pts, c.pts)):
        a = a.cpu().numpy()
        assert np.abs(a - b.numpy()).max() <= 1e-9 * np.abs(b.numpy()).max()


def test_run_ba_cuda_deterministic(cuda):
    """Two runs of the BA + outlier loop on the card are bit-identical."""
    from bundler_sfm_tpu_torch.ops import ba as T
    runs = [T.run_ba_outlier_loop(_ba_problem(cuda), max_iters=60,
                                  min_outliers=2) for _ in range(2)]
    for f in ("cam", "R", "pts", "obs_valid", "stats"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    assert runs[0].iters == runs[1].iters


def test_bundle_adjust_fast_cuda_writes_bundle(cuda, tmp_path):
    """The whole reconstruction on the card from a synthetic 6-view scene
    (verification included): bundle.out with 6 registered cameras, and
    the BA ran on CUDA."""
    from tests.synthetic import Scene as SynScene
    from bundler_sfm_tpu_torch.config import default_pipeline_config
    from bundler_sfm_tpu_torch.convert import scene_from_numpy
    from bundler_sfm_tpu_torch.io.bundlefile import read_bundle_file
    from bundler_sfm_tpu_torch.io.listfile import ImageEntry
    from bundler_sfm_tpu_torch.pipeline.incremental import bundle_adjust_fast
    from bundler_sfm_tpu_torch.pipeline.verify import (
        compute_geometric_constraints,
    )
    from bundler_sfm_tpu_torch.utils import get_telemetry
    rng = np.random.default_rng(0)
    syn = SynScene(rng, num_cams=6, num_pts=250, f=700.0, noise=0.3)
    key_xy, keymap = [], []
    for c in range(6):
        coords = np.concatenate([syn.obs[c], rng.uniform(-300, 300, (40, 2))])
        perm = rng.permutation(len(coords))
        key_xy.append(coords[perm])
        keymap.append(np.argsort(perm)[:250])
    matches = {(i, j): np.stack([keymap[i], keymap[j]], 1).astype(np.int32)
               for i in range(6) for j in range(i + 1, 6)}
    cfg = default_pipeline_config(fmatrix_rounds=512, homography_rounds=128,
                                  projection_rounds=1024, sfm_max_iters=60)
    scene = scene_from_numpy([ImageEntry(f"img{c}.jpg", init_focal=700.0)
                              for c in range(6)], [(1024, 768)] * 6,
                             key_xy, matches, cfg, device=cuda)
    compute_geometric_constraints(scene, seed=3)
    before = get_telemetry().counters.get("ba_runs_cuda", 0)
    recon = bundle_adjust_fast(scene, out_dir=str(tmp_path), seed=5)
    assert get_telemetry().counters["ba_runs_cuda"] > before
    bf = read_bundle_file(str(tmp_path / "bundle.out"))
    assert recon.num_cameras == bf.num_registered == 6
    assert len(bf.points) > 150


def test_keymatch_match_full_cuda_matches_cpu(cuda, tmp_path):
    """keymatch.match_full on the card (through the 2-NN kernel) equals its
    CPU run, with a window radius too."""
    from bundler_sfm_tpu_torch.io.keyfile import write_key_file
    from bundler_sfm_tpu_torch.keymatch import match_full
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (600, 128))
    paths = []
    for i in range(6):
        n = 600 - 50 * i
        desc = np.clip(base[:n] + rng.integers(-9, 10, (n, 128)), 0, 255)
        info = rng.uniform(0, 500, (n, 4))
        paths.append(str(tmp_path / f"k{i}.key"))
        write_key_file(paths[-1], info, desc[rng.permutation(n)])
    for window in (-1, 2):
        before = MC.LAUNCHES["two_nn"]
        g = match_full(paths, window_radius=window, device=cuda)
        assert MC.LAUNCHES["two_nn"] > before
        c = match_full(paths, window_radius=window, device="cpu")
        assert list(g) == list(c) and len(g) >= 5
        for k in g:
            assert np.array_equal(g[k], c[k])


def test_two_nn_kernels_lie_inside_match_fetch(cuda, tmp_path):
    """Under a CUDA-activity profiler, every 2-NN kernel of a small
    match_full runs inside the span log's `match_fetch` span: the spans
    and the device trace share a clock, and the host waits for the
    kernels inside that span."""
    from bundler_sfm_tpu_torch.io.keyfile import write_key_file
    from bundler_sfm_tpu_torch.keymatch import match_full
    from bundler_sfm_tpu_torch.utils import get_telemetry
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (500, 128))
    paths = []
    for i in range(5):
        desc = np.clip(base + rng.integers(-9, 10, base.shape), 0, 255)
        paths.append(str(tmp_path / f"k{i}.key"))
        write_key_file(paths[-1], rng.uniform(0, 500, (500, 4)), desc)
    with contextlib.redirect_stdout(io.StringIO()):
        match_full(paths, device=cuda)             # builds the kernel
    tel = get_telemetry()
    tel.log_spans(True)
    try:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with contextlib.redirect_stdout(io.StringIO()):
                match_full(paths, device=cuda)
        fetch = [s for s in tel.spans if s.name == "match_fetch"]
    finally:
        tel.log_spans(False)
    assert len(fetch) == 1
    kernels = [(ev.start_ns(), ev.end_ns())
               for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA
               and "two_nn" in ev.name()]
    assert kernels
    for start, end in kernels:
        assert fetch[0].start_ns <= start <= end <= fetch[0].end_ns


def _registration_problem(rng, held=3):
    """A BundleFile of 3 cameras around 300 points with a descriptor per
    point, and a 4th camera's keys (point projections + 100 distractors)
    with noisy copies of those descriptors."""
    from bundler_sfm_tpu_torch.io.bundlefile import (
        BundleCamera, BundleFile, BundlePoint,
    )
    from tests.synthetic import Scene
    sc = Scene(rng, num_cams=held + 1, num_pts=300, f=700.0, noise=0.2)
    cams = [BundleCamera(f=sc.f, k1=0.0, k2=0.0, R=sc.R[i],
                         t=-sc.R[i] @ sc.centers[i]) for i in range(held)]
    pdesc = rng.integers(0, 256, (300, 128))
    pts = [BundlePoint(pos=sc.points[p], color=np.zeros(3),
                       views=np.array([[c, p, *sc.obs[c][p]]
                                       for c in range(held)]))
           for p in range(300)]
    xy = np.concatenate([sc.obs[held], rng.uniform(-400, 400, (100, 2))])
    desc = np.concatenate([np.clip(pdesc + rng.integers(-3, 4, pdesc.shape),
                                   0, 255), rng.integers(0, 256, (100, 128))])
    return (BundleFile(cameras=cams, points=pts), pdesc.astype(np.uint8),
            desc.astype(np.uint8), xy)


def test_register_image_cuda(cuda):
    """register_image on the card launches the 2-NN kernel and agrees with
    its CPU run from the same draw: same matches and inliers, camera within
    1e-6."""
    from bundler_sfm_tpu_torch.pipeline.incremental import StageSampler
    from bundler_sfm_tpu_torch.pipeline.register import register_image
    bundle, pdesc, desc, xy = _registration_problem(np.random.default_rng(0))
    before = MC.LAUNCHES["two_nn"]
    g = register_image(bundle, pdesc, desc, xy, seed=3, device=cuda,
                       sampler=StageSampler("cpu"))
    assert MC.LAUNCHES["two_nn"] > before
    c = register_image(bundle, pdesc, desc, xy, seed=3, device="cpu",
                       sampler=StageSampler("cpu"))
    assert g is not None and c is not None and g["num_inliers"] > 250
    assert np.array_equal(g["matches"], c["matches"])
    assert np.array_equal(g["inlier_idx"], c["inlier_idx"])
    assert np.abs(g["R"] - c["R"]).max() < 1e-6
    assert np.abs(g["center"] - c["center"]).max() < \
        1e-6 * np.abs(c["center"]).max()
    assert g["f"] == pytest.approx(c["f"], rel=1e-6)


def test_run_ba_point_constraints_cuda_deterministic(cuda):
    """The BA + outlier loop with point anchors on the card: two runs
    bit-identical, anchored points kept."""
    from bundler_sfm_tpu_torch.ops import ba as T
    p = _ba_problem(cuda)
    P = p.pts0.shape[0]
    flags = np.zeros(P)
    flags[::25] = 1.0
    anchors = p.pts0.cpu().numpy() + 0.2
    p = p._replace(pt_constrained=torch.as_tensor(flags, device=cuda),
                   pt_constraints=torch.as_tensor(anchors, device=cuda),
                   pt_weight=1e6)
    runs = [T.run_ba_outlier_loop(p, max_iters=60, min_outliers=2)
            for _ in range(2)]
    for f in ("cam", "R", "pts", "obs_valid", "pt_removed", "stats"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    assert not runs[0].pt_removed[torch.as_tensor(flags > 0, device=cuda)
                                  ].any()


def test_bench_main_cuda(cuda):
    """The benchmark on the card at a small size: device metrics set, the
    MFUs in (0, 1], two_nn launched by the matcher leg (4 calls of one
    batch) and the kernel leg (16 calls) and no other kernel."""
    from bundler_sfm_tpu_torch import bench
    with contextlib.redirect_stdout(io.StringIO()):
        res = bench.main(["--num_images", "8", "--keys", "512", "--ba_small",
                          "4", "64", "--ba_big", "8", "256", "--ba_sparse",
                          "16", "512", "--ba_iters", "5"])
    d = res["detail"]
    assert d["platform"] == "cuda" and d["device"]["nvidia_smi"]
    assert all(0 < d[k] <= 1 for k in ("kernel_mfu", "ba_mfu", "ba64_mfu"))
    assert {k: v for k, v in d["launches"].items() if v} == {"two_nn": 20}
    assert len(set(d["matches_runs"])) == 1


def test_e2e_synthetic_cuda(cuda, tmp_path):
    """Keys to bundle.out on the card from 8 images x 768 keys (the scene
    tests/test_torch_e2e_synthetic.py holds the CPU run to the JAX
    package on): every camera registered within the same bounds, one
    two_nn launch."""
    from bundler_sfm_tpu_torch.probes import e2e_synthetic
    with contextlib.redirect_stdout(io.StringIO()):
        line = e2e_synthetic.main(["8", "768", "--workdir", str(tmp_path)])
    ours = line["ours"]
    assert ours["cameras"] == 8 and ours["mean_reproj_px"] < 1.0
    assert ours["ate_rel"] < 0.02
    assert {k: v for k, v in ours["launches"].items() if v} == {"two_nn": 1}


def test_e2e_pixels_cuda(cuda, tmp_path):
    """JPEGs to bundle.out on the card from the 12-view 320x240 render
    tests/test_torch_e2e_pixels.py holds the CPU run to the JAX package
    on: the 5 cameras every CPU draw registers, within the quality gates,
    SIFT's peak memory recorded, one two_nn launch, a .key file a view."""
    from bundler_sfm_tpu_torch.probes import e2e_pixels
    from bundler_sfm_tpu_torch.utils.render_scene import render_box_room
    render_box_room(str(tmp_path / "views"), n=12, W=320, H=240, seed=0,
                    f=140.0, sheet_size=512)
    with contextlib.redirect_stdout(io.StringIO()):
        line = e2e_pixels.main([str(tmp_path / "views"), "--max_keys",
                                "1024", "--workdir", str(tmp_path / "run")])
    ours = line["ours"]
    assert ours["device"]["nvidia_smi"] and ours["sift_peak_bytes"] > 0
    assert ours["cameras"] == 5 and ours["mean_reproj_px"] < 1.0
    assert ours["ate_rel"] < 0.02
    assert {k: v for k, v in ours["launches"].items() if v} == {"two_nn": 1}
    assert len(list((tmp_path / "run").glob("*.key"))) == 12


def test_scaling_cuda(cuda):
    """The scaling program on the card at a toy size: platform cuda, the
    matcher leg's two_nn launches (2 batch sizes x a warm and a timed
    call x 4 launches) and no other kernel."""
    from bundler_sfm_tpu_torch.ops.matching import launch_counts
    from bundler_sfm_tpu_torch.probes import scaling
    before = launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        res = scaling.main(["--cams", "6", "--pts", "192", "--obs_per_pt",
                            "4", "--iters", "3", "--match_keys", "256",
                            "--match_batches", "2,4"])
    moved = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
    assert res["platform"] == "cuda" and res["device"]["nvidia_smi"]
    assert moved == {"two_nn": 16}
    assert all(v > 0 for v in res["ba_measured_ms_per_iter_per_shard"]
               .values())


def test_scaling_mesh_cpu_on_card_host(cuda):
    """The gloo CPU program on the card's host: D = 1 and 2 agree."""
    from bundler_sfm_tpu_torch.probes import scaling_mesh_cpu
    with contextlib.redirect_stdout(io.StringIO()):
        res = scaling_mesh_cpu.main(["--pts", "512", "--iters", "5",
                                     "--devices", "1,2"])
    cost = res["final_cost_by_devices"]
    assert cost[2] == pytest.approx(cost[1], rel=1e-9, abs=0)
