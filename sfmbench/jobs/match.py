"""Job kind `match`: KeyMatchFull over a collection's key files, through
the port's entry `bundler_sfm_tpu_torch.keymatch.match_full`.

Inputs: the configuration's box room (`gen/views.py`) rendered from
`traffic["views"]` cameras on its orbit, as ToSift would see it: each
JPEG through the port's SIFT (`extract_sift_batch` with the
configuration's key cap and contrast threshold, as `run_bundler` calls
it), written as Lowe-format `.key` text files.  The seed orders the files
(and so which image of a pair queries the other) and draws the checked
pairs; every seed matches the same views.  A job reads every file,
matches every pair j < i (ratio test, keep-first dedup, at least
`min_matches` matches) and ends with the match table in host memory: the
dict `write_match_file` takes.  The text file is not written.

The answers are judged by `reference/matching.py` on the descriptors the
key files hold: a sample of pairs drawn from the seed, each compared
exactly in every job of the window.
"""

from __future__ import annotations

import os

import numpy as np

from sfmbench import roofline
from sfmbench.gen import keys, views
from sfmbench.reference import matching


def prepare(config, traffic, seed, workdir, device):
    import torch

    from bundler_sfm_tpu_torch.features.sift import (
        extract_sift_batch, load_grayscale)
    n = int(traffic["views"])
    image_dir = os.path.join(workdir, "images")
    views.render(config, n, image_dir)
    grays = [load_grayscale(os.path.join(image_dir, f"img{i:04d}.jpg"))
             for i in range(n)]
    sift = extract_sift_batch(grays, max_keys_total=int(config["max_keys"]),
                              contrast_thr=float(config["contrast_thr"]),
                              device=device)
    del grays
    if device.type == "cuda":
        torch.cuda.empty_cache()
    order = np.random.default_rng(seed).permutation(n)
    key_dir = os.path.join(workdir, "keys")
    os.makedirs(key_dir)
    files, descs = [], []
    for k, view in enumerate(order):
        info, desc = sift[view]
        files.append(os.path.join(key_dir, f"img{view:04d}.key"))
        keys.write_key_file(files[-1], info, desc)
        descs.append(np.asarray(desc, np.uint8))
    pairs = [(j, i) for i in range(n) for j in range(i)]
    counts = [len(d) for d in descs]
    return {"key_files": files, "descs": descs, "pairs": pairs,
            "ratio": float(config["ratio"]),
            "min_matches": int(config["min_matches"]),
            "sample": int(traffic["checked_pairs"]),
            "least_s": roofline.pairs_least_seconds(counts, pairs)}


def run(inputs, job_dir, device):
    from bundler_sfm_tpu_torch.keymatch import match_full
    return match_full(inputs["key_files"], ratio=inputs["ratio"],
                      min_matches=inputs["min_matches"], device=str(device))


def work(inputs, answer):
    return {"pairs": len(inputs["pairs"]), "two_nn_least_s": inputs["least_s"]}


def sample_pairs(inputs, seed):
    """The pairs checked in this run, drawn from the seed."""
    pairs = inputs["pairs"]
    pick = np.random.default_rng(seed).choice(
        len(pairs), min(inputs["sample"], len(pairs)), replace=False)
    return [pairs[k] for k in np.sort(pick)]


def _reference(inputs, pairs, device, bits=8):
    d = inputs["descs"]
    return {(a, b): matching.match_pair(d[a], d[b], inputs["ratio"],
                                        inputs["min_matches"], device, bits)
            for a, b in pairs}


def control(inputs, job_dir, device, seed):
    """The reference in the program's place at 4 bits an entry (the
    precision step below the uint8 descriptors), on the pairs this run
    checks."""
    ref = _reference(inputs, sample_pairs(inputs, seed), device, bits=4)
    return {p: m for p, m in ref.items() if m is not None}


def judge(inputs, answers, limits, seed, device):
    pairs = sample_pairs(inputs, seed)
    ref = _reference(inputs, pairs, device)
    differing = 0
    for table in answers:
        for p in pairs:
            got, want = table.get(p), ref[p]
            if (got is None) != (want is None) or (
                    want is not None and not np.array_equal(got, want)):
                differing += 1
    return [{"name": "pairs_differing", "value": differing,
             "limit": limits["pairs_differing"]}]
