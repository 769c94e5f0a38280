"""Job kind `sfm`: RunBundler.sh's last step, `bundler list.txt
--options_file options.txt`, on what ToSift and KeyMatchFull left on disk,
through the port's entry `bundler_sfm_tpu_torch.bundler.main`.

Inputs (`prepare`, written once a run into `<workdir>/arc`): the
configuration's arc collection (`gen/arc.py`, from its scene seed alone)
of `traffic["views"]` views with `traffic["keys"]` keys each, as

    images/img%04d.jpg      JPEGs textured from the scene seed
    images/img%04d.key.gz   Lowe text keys, gzip'd (bin/ToSift.sh:30-35)
    list.txt                images/img%04d.jpg 0 <focal> (extract_focal.pl)
    matches.init.txt        KeyMatchFull's table (ratio, >= min_matches),
                            made by the plain matcher `reference/matching.py`
    options.txt             RunBundler.sh's options (RunBundler.sh:119-137)

Each job runs in a fresh directory of its own (bundler loads a
`constraints.txt` it finds there and skips verification), with the inputs
linked in; its answer is `bundle/bundle.out`, judged against the arc's
camera centres by `reference/bundle.py` as in job kind `full`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import os
import sys

import numpy as np

from sfmbench.gen import arc, keys
from sfmbench.reference import bundle, matching

# RunBundler.sh:119-137, line for line.
OPTIONS = ("--match_table matches.init.txt", "--output bundle.out",
           "--output_all bundle_", "--output_dir bundle",
           "--variable_focal_length", "--use_focal_estimate",
           "--constrain_focal", "--constrain_focal_weight 0.0001",
           "--estimate_distortion", "--ray_angle_threshold 2.0",
           "--run_bundle")
SHARED = ("images", "list.txt", "matches.init.txt", "options.txt")


def match_table(descs, ratio, min_matches, device):
    """KeyMatchFull's `matches.init.txt` (`src/KeyMatchFull.cpp:118-142`)
    and its number of pairs: for each image i, each earlier image j
    queries it, and a pair with at least `min_matches` matches is written
    as "j i", its count, then one "query db" line a match."""
    out, pairs = [], 0
    for i in range(len(descs)):
        for j in range(i):
            m = matching.match_pair(descs[j], descs[i], ratio, min_matches,
                                    device)
            if m is not None:
                pairs += 1
                out.append(b"%d %d\n%d\n" % (j, i, len(m)))
                out.extend(b"%d %d\n" % (a, b) for a, b in m.tolist())
    return b"".join(out), pairs


def write_collection(root, infos, descs, focal, ratio, min_matches,
                     device) -> int:
    """The key files, list.txt, matches.init.txt and options.txt of the
    views under `root` (the JPEGs go in `root/images`); returns the number
    of matched pairs."""
    image_dir = os.path.join(root, "images")
    os.makedirs(image_dir, exist_ok=True)
    for i, (info, desc) in enumerate(zip(infos, descs)):
        with open(os.path.join(image_dir, f"img{i:04d}.key.gz"), "wb") as f:
            f.write(gzip.compress(keys.key_file_bytes(info, desc),
                                  compresslevel=6, mtime=0))
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.writelines(f"images/img{i:04d}.jpg 0 {focal:0.5f}\n"
                     for i in range(len(infos)))
    table, pairs = match_table(descs, ratio, min_matches, device)
    with open(os.path.join(root, "matches.init.txt"), "wb") as f:
        f.write(table)
    with open(os.path.join(root, "options.txt"), "w") as f:
        f.writelines(line + "\n" for line in OPTIONS)
    return pairs


def prepare(config, traffic, seed, workdir, device):
    """The collection from the configuration's scene seed alone, whatever
    `seed` says: an incremental reconstruction's work moves with any
    change of input (job kind `full`)."""
    n = int(traffic["views"])
    w, h = int(config["width"]), int(config["height"])
    focal = float(config["focal"])
    infos, descs, gt = arc.synthesize(
        n, int(traffic["keys"]), float(traffic["track_ratio"]),
        seed=int(config["scene_seed"]), width=w, height=h, focal=focal,
        pix_noise=float(config["pixel_noise"]))
    root = os.path.join(workdir, "arc")
    arc.write_views(os.path.join(root, "images"), n, w, h,
                    int(config["scene_seed"]))
    pairs = write_collection(root, infos, descs, focal,
                             float(config["ratio"]),
                             int(config["min_matches"]), device)
    print(f"[sfmbench] sfm inputs: {n} views x {int(traffic['keys'])} "
          f"keys, {pairs} of {n * (n - 1) // 2} pairs matched",
          file=sys.stderr)
    return {"root": root, "views": n, "gt_centers": gt["centers"],
            "matched_pairs": pairs}


def run(inputs, job_dir, device, extra=()):
    from bundler_sfm_tpu_torch import bundler
    for name in SHARED:
        os.symlink(os.path.join(inputs["root"], name),
                   os.path.join(job_dir, name))
    cwd = os.getcwd()
    os.chdir(job_dir)
    try:
        rc = bundler.main(["list.txt", "--options_file", "options.txt",
                           "--device", str(device), *extra])
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"bundler returned {rc}")
    return os.path.join(job_dir, "bundle", "bundle.out")


@contextlib.contextmanager
def _float32_stage5(state=None):
    """Stage 5 computed in float32 on the device: every float64 tensor the
    incremental loop builds (`incremental._T`: the initial pair, resection,
    refine, triangulation) and every bundle-adjustment problem
    (`build_problem`) made float32, so resection, the refine LM, the
    triangulation and BA's normal equations, Schur solve and LM run in
    float32; the refine LM takes the plain tensor loop, since the CUDA
    kernel is float64 only, and the incremental rotation exp([w]x)
    (`rotations.rodrigues`, whose forward-mode derivative PyTorch promotes
    to float64 on a 0-dim float32 angle) is rounded to float32.  With
    `state` (a 16-bit dtype), every floating array stage 5 brings back to
    the host (`incremental._np`: cameras, rotations, points, after each
    step) is rounded through it, the state kept in 16 bits where no
    solver computes in them."""
    import torch
    from bundler_sfm_tpu_torch.ops import lm, rotations
    from bundler_sfm_tpu_torch.pipeline import incremental as inc
    saved = (inc._T, inc.build_problem, lm.camera_refine_batch,
             rotations.rodrigues, inc._np)

    def tensor32(x, dev, dtype=torch.float64):
        return saved[0](x, dev,
                        torch.float32 if dtype == torch.float64 else dtype)

    def build32(*args, **kw):
        prob = saved[1](*args, **kw)
        return prob._replace(**{
            f.name: v.float() for f in dataclasses.fields(prob)
            if isinstance(v := getattr(prob, f.name), torch.Tensor)
            and v.dtype == torch.float64})

    def rounded(x):
        if x.is_floating_point():
            x = x.to(state).to(x.dtype)
        return saved[4](x)
    inc._T, inc.build_problem = tensor32, build32
    lm.camera_refine_batch = lm.camera_refine_batch_plain
    rotations.rodrigues = lambda w: saved[3](w.double()).to(w.dtype)
    if state is not None:
        inc._np = rounded
    try:
        yield
    finally:
        (inc._T, inc.build_problem, lm.camera_refine_batch,
         rotations.rodrigues, inc._np) = saved


def _lower(inputs, job_dir, device, state=None):
    from bundler_sfm_tpu_torch import bundler
    orig = bundler.BundlerConfig
    bundler.BundlerConfig = lambda **kw: orig(**kw, ba_dtype="float32")
    try:
        with _float32_stage5(state):
            return run(inputs, job_dir, device)
    finally:
        bundler.BundlerConfig = orig


def control(inputs, job_dir, device, seed):
    """The job in float32: the F / H verification with the port's own
    switch (`ba_dtype="float32"`, which reaches the key coordinates),
    stage 5 in float32 (`_float32_stage5`)."""
    return _lower(inputs, job_dir, device)


def control_float16(inputs, job_dir, device, seed):
    """The float32 job with stage 5's state rounded through float16 after
    every step: 16 bits, the precision below float32."""
    import torch
    return _lower(inputs, job_dir, device, torch.float16)


def control_bfloat16(inputs, job_dir, device, seed):
    """As `control_float16`, through bfloat16."""
    import torch
    return _lower(inputs, job_dir, device, torch.bfloat16)


def control_skip_full_bundle(inputs, job_dir, device, seed):
    """The job with bundler's --skip_full_bundle: no bundle adjustment over
    all cameras after each round, which breaks the configuration's
    `full_bundle` guarantee."""
    return run(inputs, job_dir, device, extra=("--skip_full_bundle",))


def work(inputs, answer):
    return {"images": int(bundle.registered(bundle.read_bundle(answer)).sum())}


def _worst(values):
    values = [float(v) for v in values]
    return float("nan") if any(np.isnan(values)) else max(values)


def judge(inputs, answers, limits, seed, device):
    """Each number of `limits`, the worst over the answers."""
    scores = [bundle.score(a, inputs["gt_centers"]) for a in answers]
    for s in scores:
        s["cameras_missing"] = inputs["views"] - s["cameras"]
    return [{"name": name, "value": _worst(s[name] for s in scores),
             "limit": limit} for name, limit in limits.items()]


def diagnose(inputs, answer):
    """Every score of one answer (`sfmbench/control.py` prints them)."""
    return bundle.score(answer, inputs["gt_centers"])
