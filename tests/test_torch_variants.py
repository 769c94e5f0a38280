"""The port's 2-NN variants (`ops/matching_variants.py`, the counterparts of
`benchmarks/probes/probe_pallas_variants.py`) against the JAX package, on
the CPU.

The probe's Pallas kernels are closures inside its `main()`, so each
reference here is composed from the JAX package's own pieces in plain
`jnp`: `_tile_top2` over the whole score row (oneblock), `_tile_top2` per
512-column block folded by `_merge_top2` (bf16 blockmerge), and the row
max of the dots or `_tile_top2`'s m0/i0 (ablations).  The exact variants
are also held against `two_nn_pallas(..., interpret=True)` and the port's
`two_nn_pairs`.  On the CPU the wrappers run their plain versions; the
kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Tolerance: exact — every output bit-identical.
"""

import tests.torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundler_sfm_tpu.ops.matching_pallas import (
    _BIG, _merge_top2, _tile_top2, two_nn_pallas,
)
from bundler_sfm_tpu_torch.ops import matching_variants as V
from bundler_sfm_tpu_torch.ops.matching_cuda import two_nn_pairs
from bundler_sfm_tpu_torch.probes import probe_two_nn_variants as P

# name: (K, counts of the 6 images)
CASES = {
    "ragged256": (256, [256, 200, 129, 1, 0, 256]),
    "ties512": (512, [512, 490, 300, 65, 1, 0]),
    "hits1024": (1024, [1024, 1000, 777, 513, 1, 0]),
}
PAIRS = [(0, 0), (0, 1), (1, 0), (2, 3), (3, 4), (4, 5), (5, 0), (1, 4),
         (2, 2)]
KINDS = ("oneblock", "blockmerge", "matmul_max", "top1")


def _table(name):
    """Centered int8 [6, K, 128] with duplicated db rows (ties), a db of one
    repeated row and query rows equal to db rows (distance-0 hits)."""
    K, counts = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    tab = rng.integers(0, 256, (6, K, 128))
    tab[0, K // 2:K // 2 + 50] = tab[0, 0:50]
    tab[0, K - 1] = tab[0, 3]
    tab[2, :] = tab[2, 7]
    tab[1, :60] = tab[0, 10:70]
    tab[3, :40] = np.clip(tab[0, :40] + rng.integers(-2, 3, (40, 128)), 0, 255)
    for i, n in enumerate(counts):
        tab[i, n:] = 0
    return ((tab - 128).astype(np.int8), np.array(counts, np.int32))


def _jax_variant(kind, q, db, count):
    """The probe's kernel body for one pair, from the JAX package's pieces."""
    with jax.enable_x64(False):
        q, db = jnp.asarray(q), jnp.asarray(db)
        dots = jax.lax.dot_general(
            q, db, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32).astype(jnp.float32)
        nq = q.shape[0]
        if kind == "matmul_max":
            return (jnp.max(dots, axis=1), jnp.zeros((nq,), jnp.int32),
                    jnp.zeros((nq,), jnp.float32))
        bi = db.astype(jnp.int32)
        bsq = jnp.sum(bi * bi, axis=1).astype(jnp.float32)
        bsq = jnp.where(jnp.arange(db.shape[0], dtype=jnp.int32) < count,
                        bsq, jnp.float32(_BIG))
        m = dots - 0.5 * bsq[None, :]
        if kind == "blockmerge":
            bd = V.BLOCKMERGE_BD
            col = jax.lax.broadcasted_iota(jnp.int32, (nq, bd), 1)
            r = (jnp.full((nq,), -_BIG, jnp.float32),
                 jnp.zeros((nq,), jnp.int32),
                 jnp.full((nq,), -_BIG, jnp.float32))
            for start in range(0, db.shape[0], bd):
                m0, i0, m1 = _tile_top2(m[:, start:start + bd], col)
                r = _merge_top2(*r, m0, start + i0, m1)
            m0, i0, m1 = r
        else:
            col = jax.lax.broadcasted_iota(jnp.int32, m.shape, 1)
            m0, i0, m1 = _tile_top2(m, col)
        qi = q.astype(jnp.int32)
        qsq = jnp.sum(qi * qi, axis=1).astype(jnp.float32)
        d1 = (qsq - 2.0 * m1 if kind != "top1"
              else jnp.zeros((nq,), jnp.float32))
        return qsq - 2.0 * m0, i0, d1


def _jax_pairs(kind, tab, counts, pairs):
    outs = [[np.asarray(x) for x in _jax_variant(kind, tab[i], tab[j],
                                                 counts[j])]
            for i, j in pairs]
    return [np.stack(o) for o in zip(*outs)]


def _port(kind, tab, counts, pairs, **kw):
    t, c = torch.from_numpy(tab), torch.from_numpy(counts)
    p = torch.tensor(pairs, dtype=torch.int32).reshape(-1, 2)
    args = (t, c, p[:, 0].contiguous(), p[:, 1].contiguous())
    if kind == "oneblock":
        out = V.two_nn_oneblock(*args, **kw)
    elif kind == "blockmerge":
        out = V.two_nn_blockmerge_bf16(*args)
    else:
        out = V.two_nn_ablation(*args, mode=kind)
    return [x.numpy() for x in out]


def _assert_identical(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case,kind", [
    (c, k) for c in CASES for k in KINDS
    if k != "blockmerge" or CASES[c][0] % V.BLOCKMERGE_BD == 0])
def test_plain_matches_jax_composition(case, kind):
    tab, counts = _table(case)
    _assert_identical(_port(kind, tab, counts, PAIRS),
                      _jax_pairs(kind, tab, counts, PAIRS))


@pytest.mark.parametrize("case", list(CASES))
def test_exact_variants_match_pallas_interpret(case):
    """Against the TPU kernel itself, in Pallas interpret mode."""
    tab, counts = _table(case)
    pairs = [(0, 1), (2, 3), (4, 5)]
    want = [np.stack(o) for o in zip(*[
        [np.asarray(x) for x in two_nn_pallas(
            jnp.asarray(tab[i]), jnp.asarray(tab[j]), jnp.int32(counts[j]),
            interpret=True)] for i, j in pairs])]
    _assert_identical(_port("oneblock", tab, counts, pairs), want)
    if CASES[case][0] % V.BLOCKMERGE_BD == 0:
        _assert_identical(_port("blockmerge", tab, counts, pairs), want)


@pytest.mark.parametrize("case", list(CASES))
def test_exact_variants_equal_two_nn_pairs(case):
    """Bit-identical to the production matcher, d1 = 3e38 and i0 = 0 where
    fewer than two db rows are valid included."""
    tab, counts = _table(case)
    t, c = torch.from_numpy(tab), torch.from_numpy(counts)
    p = torch.tensor(PAIRS, dtype=torch.int32)
    want = [x.numpy() for x in two_nn_pairs(t, t, c, p[:, 0], p[:, 1])]
    _assert_identical(_port("oneblock", tab, counts, PAIRS), want)
    if CASES[case][0] % V.BLOCKMERGE_BD == 0:
        _assert_identical(_port("blockmerge", tab, counts, PAIRS), want)
    few = counts[[j for _, j in PAIRS]] < 2
    assert few.any()
    assert (want[2][few] == np.float32(3e38)).all()
    assert (want[1][counts[[j for _, j in PAIRS]] == 0] == 0).all()


def _bad_call(what):
    tab = torch.zeros((2, 256, 128), dtype=torch.int8)
    c = torch.tensor([256, 256], dtype=torch.int32)
    p = torch.zeros(1, dtype=torch.int32)
    return {
        "dtype": (lambda: V.two_nn_oneblock(tab.float(), c, p, p),
                  "centered int8"),
        "tile": (lambda: V.two_nn_oneblock(tab, c, p, p, tq=512),
                 "K % 512"),
        "block": (lambda: V.two_nn_blockmerge_bf16(tab, c, p, p), "K % 512"),
        "ablation_k": (lambda: V.two_nn_ablation(tab[:, :200], c, p, p,
                                                 "top1"), "K % 128"),
        "mode": (lambda: V.two_nn_ablation(tab, c, p, p, "top2"),
                 "unknown mode"),
        "tq": (lambda: V.two_nn_oneblock(tab, c, p, p, tq=64),
               "tq must be"),
        "dot": (lambda: V.two_nn_oneblock(tab, c, p, p, dot="fp8"),
                "dot must be"),
        "index": (lambda: V.two_nn_oneblock(tab, c, p, p + 2),
                  "out of range"),
        "count": (lambda: V.two_nn_ablation(tab, c + 1, p, p, "matmul_max"),
                  "out of range"),
        "ablation_index": (lambda: V.two_nn_ablation(
            tab, c, p - 1, p, "matmul_max"), "out of range"),
        "index_dtype": (lambda: V.two_nn_blockmerge_bf16(
            torch.zeros((1, 512, 128), dtype=torch.int8), c[:1], p.long(),
            p), "int32"),
        "device": (lambda: V.two_nn_oneblock(tab.to("meta"), c.to("meta"),
                                             p.to("meta"), p.to("meta")),
                   "unsupported device"),
    }[what]


@pytest.mark.parametrize("what", ["dtype", "tile", "block", "ablation_k",
                                  "mode", "tq", "dot", "index", "count",
                                  "index_dtype", "device", "ablation_index"])
def test_wrappers_reject_bad_inputs(what):
    fn, msg = _bad_call(what)
    with pytest.raises(ValueError, match=msg):
        fn()


@pytest.mark.parametrize("n_pairs,keys", [(15, 256), (6, 1024)])
def test_probe_matches_jax_composition(n_pairs, keys):
    """The probe entry point on the CPU: every variant that fits K gives
    the JAX composition's outputs on the probe's own table."""
    lines = []
    res = P.run(n_pairs, keys, device="cpu", log=lines.append)
    tab, counts = (x.numpy() for x in P.make_table(keys, "cpu"))
    pairs = P.make_pairs(n_pairs)
    assert len(pairs) == n_pairs
    kind = {"base": "oneblock", "bf16": "blockmerge",
            "ABL_matmul_max": "matmul_max", "ABL_top1": "top1"}
    want = {k: _jax_pairs(k, tab, counts, pairs) for k in KINDS
            if k != "blockmerge" or keys % V.BLOCKMERGE_BD == 0}
    expected = [n for n, *_, m in P.variants() if keys % m == 0]
    assert list(res) == expected
    for name, r in res.items():
        k = kind.get(name, "oneblock")
        _assert_identical([x.numpy() for x in r["outputs"]], want[k])
        assert r["ms"] is None
        assert r["vs_base"] == ("ref" if name == "base" else
                                "ablation" if name.startswith("ABL")
                                else "IDENTICAL")
    skipped = [ln for ln in lines if "skipped" in ln]
    assert len(skipped) == len(P.variants()) - len(expected)


def test_probe_cli_cpu(capsys):
    assert P.main(["4", "512", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu") and "P=4 K=512" in out[0]
    body = {ln.split()[0]: ln for ln in out[1:]}
    assert list(body) == [n for n, *_ in P.variants()]
    assert "skipped" in body["oneblock_i8_1024"]
    assert body["bf16"].endswith("vs_base: IDENTICAL")
    assert "ms:" not in "".join(out)
