"""Job kind `full`: RunBundler.sh's pipeline (ToSift → KeyMatchFull →
bundler) from a directory of JPEGs to `bundle.out`, through the port's
entry `bundler_sfm_tpu_torch.run_bundler.main`.

Inputs: the configuration's box room (`gen/room.py`, its texture seed
fixed by the configuration) rendered from `traffic["views"]` cameras on
its orbit, in orbit order on every seed (see `prepare`).  Each job runs
in a fresh directory of its own (run_bundler writes list.txt and
matches.init.txt into its working directory) and reads the JPEGs afresh.

The answer is the job's `bundle.out`, judged against the render's ground
truth by `reference/bundle.py`: every view registered, the mean
reprojection error, and the camera centres' error after a similarity.
"""

from __future__ import annotations

import os

import numpy as np

from sfmbench.gen import views
from sfmbench.reference import bundle


def prepare(config, traffic, seed, workdir, device):
    """The views in orbit order, whatever the seed: an incremental
    reconstruction's work moves with any change to its input (over 18
    view orders a job's `ba` span took 2.6 to 24.6 s on one card), so a
    seed that changed the input would change the work."""
    n = int(traffic["views"])
    image_dir = os.path.join(workdir, "images")
    centers = views.render(config, n, image_dir)
    return {"image_dir": image_dir, "views": n,
            "focal": float(config["focal"]),
            "max_keys": int(config["max_keys"]), "gt_centers": centers}


def run(inputs, job_dir, device):
    from bundler_sfm_tpu_torch import run_bundler
    out = os.path.join(job_dir, "bundle")
    cwd = os.getcwd()
    os.chdir(job_dir)
    try:
        rc = run_bundler.main([inputs["image_dir"], "--init_focal",
                               repr(inputs["focal"]), "--max_keys",
                               str(inputs["max_keys"]), "--out", out,
                               "--device", str(device)])
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"run_bundler returned {rc}")
    return os.path.join(out, "bundle.out")


def _with_config(inputs, job_dir, device, **overrides):
    import bundler_sfm_tpu_torch.config as cfg_mod
    orig = cfg_mod.default_pipeline_config
    cfg_mod.default_pipeline_config = \
        lambda **kw: orig(**{**kw, **overrides})
    try:
        return run(inputs, job_dir, device)
    finally:
        cfg_mod.default_pipeline_config = orig


def control(inputs, job_dir, device, seed):
    """The job with the port's own lower-precision path switched on
    (`ba_dtype="float32"`): float32 in place of float64 where the port
    reads that switch, the key coordinates of the F / H verification."""
    return _with_config(inputs, job_dir, device, ba_dtype="float32")


def control_skip_full_bundle(inputs, job_dir, device, seed):
    """The job with the port's `skip_full_bundle` switched on: no bundle
    adjustment over all cameras after each round, which breaks the
    configuration's `full_bundle` guarantee."""
    return _with_config(inputs, job_dir, device, skip_full_bundle=True)


def work(inputs, answer):
    return {"images": int(bundle.registered(bundle.read_bundle(answer)).sum())}


def _worst(values):
    values = [float(v) for v in values]
    return float("nan") if any(np.isnan(values)) else max(values)


def judge(inputs, answers, limits, seed, device):
    """Each number of `limits`, the worst over the answers."""
    scores = [bundle.score(a, inputs["gt_centers"])
              for a in answers]
    for s in scores:
        s["cameras_missing"] = inputs["views"] - s["cameras"]
    return [{"name": name, "value": _worst(s[name] for s in scores),
             "limit": limit} for name, limit in limits.items()]


def diagnose(inputs, answer):
    """Every score of one answer (`sfmbench/control.py` prints them)."""
    return bundle.score(answer, inputs["gt_centers"])
