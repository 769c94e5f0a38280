"""Probe of the exact 2-NN matcher's variants on the card, side by side.

Counterpart of `benchmarks/probes/probe_pallas_variants.py`: the same data
(24 images of K keys, a base plus jitter in [-6, 6], permuted, centered
int8, seed 0; the 276 pairs i < j cycled to the pair count asked for) and
the same variant list, run through the port's kernels:

  base               `matching_cuda.two_nn_pairs` (csrc/two_nn.cu)
  oneblock_i8_<tq>   `two_nn_oneblock`, int8 dot, tq in 128..1024
  oneblock_bf16_128  `two_nn_oneblock`, bf16 dot, tq 128
  bf16               `two_nn_blockmerge_bf16`
  ABL_matmul_max     `two_nn_ablation(mode="matmul_max")` (not a matcher)
  ABL_top1           `two_nn_ablation(mode="top1")` (not a matcher)

    python -m bundler_sfm_tpu_torch.probes.probe_two_nn_variants \
        [pairs] [keys] [--device cuda|cpu]

For each variant it prints pairs/s, TOP/s and the share of the H100's
dense int8 peak (and of its bf16 peak for the bf16 dots), timed by CUDA
events as the best of three pair orders after a warm-up call, and for the
exact variants whether the outputs are IDENTICAL to `base`'s.  A variant
whose tile does not divide K is skipped, and says so.  Any other failure
raises.  On the CPU the wrappers run their plain versions and nothing is
timed.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from bundler_sfm_tpu_torch.ops import matching_variants as V
from bundler_sfm_tpu_torch.ops.matching_cuda import two_nn_pairs
from bundler_sfm_tpu_torch.utils.device import resolve_device

N_IMAGES = 24
INT8_OPS_S = 1979e12     # H100 SXM dense int8 tensor-core peak
BF16_OPS_S = 989e12      # H100 SXM dense bf16 tensor-core peak
REPS_PER_ORDER = 3


def make_table(keys: int, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's descriptor table [24, keys, 128] (centered int8) and
    counts (all `keys`), from seed 0."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (keys, 128)).astype(np.int32)
    descs = [np.clip(base + rng.integers(-6, 7, base.shape), 0, 255
                     ).astype(np.uint8)[rng.permutation(keys)]
             for _ in range(N_IMAGES)]
    table = np.stack([(d.astype(np.int16) - 128).astype(np.int8)
                      for d in descs])
    dev = resolve_device(device)
    return (torch.from_numpy(table).to(dev),
            torch.full((N_IMAGES,), keys, dtype=torch.int32, device=dev))


def make_pairs(n_pairs: int) -> List[Tuple[int, int]]:
    """All pairs i < j of the 24 images, cycled to `n_pairs`."""
    pairs = [(i, j) for i in range(N_IMAGES) for j in range(i + 1, N_IMAGES)]
    while len(pairs) < n_pairs:
        pairs += pairs
    return pairs[:n_pairs]


class Variant(NamedTuple):
    """One probe variant.  `kernel` names its launch counter: "two_nn" in
    `matching_cuda.LAUNCHES`, else a key of `matching_variants.LAUNCHES`."""
    name: str
    fn: Callable          # fn(table, counts, pi, pj) -> (d0, i0, d1)
    kernel: str
    exact: bool           # a matcher (else an ablation)
    bf16: bool            # bf16 dot
    multiple: int         # K must be a multiple of this


def variants() -> List[Variant]:
    def oneblock(tq, dot):
        return Variant(f"oneblock_{'i8' if dot == 'int8' else dot}_{tq}",
                       lambda *a: V.two_nn_oneblock(*a, tq=tq, dot=dot),
                       f"two_nn_oneblock_{dot}_{tq}", True, dot == "bf16", tq)

    def ablation(mode):
        return Variant(f"ABL_{mode}",
                       lambda *a: V.two_nn_ablation(*a, mode=mode),
                       f"two_nn_ablation_{mode}", False, False, V.ABLATION_TQ)

    return ([Variant("base", lambda t, c, i, j: two_nn_pairs(t, t, c, i, j),
                     "two_nn", True, False, 128)]
            + [oneblock(tq, "int8") for tq in V.ONEBLOCK_TILES]
            + [oneblock(128, "bf16"),
               Variant("bf16", V.two_nn_blockmerge_bf16,
                       "two_nn_blockmerge_bf16", True, True, V.BLOCKMERGE_BD),
               ablation("matmul_max"), ablation("top1")])


def _best_ms(fn, table, counts, pi, pj, orders) -> float:
    """Best over the pair orders of the mean device time of one call."""
    best = float("inf")
    for o in orders:
        a, b = pi[o].contiguous(), pj[o].contiguous()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS_PER_ORDER):
            fn(table, counts, a, b)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / REPS_PER_ORDER)
    return best


def run(n_pairs: int = 276, keys: int = 2048, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Run every variant once (the warm-up, and the outputs compared with
    `base`), then time it on CUDA.  Returns {name: {"outputs", "vs_base",
    "ms"}} for the variants that ran; "ms" is None on the CPU."""
    dev = resolve_device(device)
    table, counts = make_table(keys, dev)
    pairs = make_pairs(n_pairs)
    pi = torch.tensor([i for i, _ in pairs], dtype=torch.int32, device=dev)
    pj = torch.tensor([j for _, j in pairs], dtype=torch.int32, device=dev)
    n = len(pairs)
    orders = [torch.arange(n - 1, -1, -1, device=dev),
              torch.roll(torch.arange(n, device=dev), 1),
              torch.roll(torch.arange(n, device=dev), 2)]
    ops = n * 2.0 * keys * keys * 128
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions, not timed)")
    log(f"device: {where} P={n} K={keys}")
    results: Dict[str, dict] = {}
    base = None
    for name, fn, _, exact, bf16, multiple in variants():
        if keys % multiple:
            log(f"{name:18s} skipped: K % {multiple} != 0")
            continue
        out = fn(table, counts, pi, pj)
        if base is None:
            base, match = out, "ref"
        elif exact:
            match = ("IDENTICAL" if all(torch.equal(x, y)
                                        for x, y in zip(out, base))
                     else "MISMATCH")
        else:
            match = "ablation"
        ms = None
        line = f"{name:18s} "
        if dev.type == "cuda":
            ms = _best_ms(fn, table, counts, pi, pj, orders)
            rate = ops / (ms * 1e-3)
            line += (f"ms: {ms:9.4f}  pairs/s: {n / (ms * 1e-3):9.0f}  "
                     f"TOP/s: {rate / 1e12:7.2f}  "
                     f"int8 peak: {100 * rate / INT8_OPS_S:5.2f}%  ")
            if bf16:
                line += f"bf16 peak: {100 * rate / BF16_OPS_S:5.2f}%  "
        log(line + f"vs_base: {match}")
        results[name] = {"outputs": out, "vs_base": match, "ms": ms}
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="probe_two_nn_variants",
        description="Exact 2-NN variants on the card, side by side.")
    p.add_argument("pairs", nargs="?", type=int, default=276)
    p.add_argument("keys", nargs="?", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions and times nothing)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    results = run(args.pairs, args.keys, args.device,
                  log=lambda s: print(s, flush=True))
    return 1 if any(r["vs_base"] == "MISMATCH" for r in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
