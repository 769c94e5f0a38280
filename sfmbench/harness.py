"""One run of one cell: set-up, a warm-up job, the measured window of
whole jobs, the check of every job's answer against the plain reference,
and the metrics read from the run's record.

The cell comes from `BENCHMARK.json`; its configuration, traffic mix,
limits and metric readers from files found by name under `data_root`
(this package's directory):

    configs/<config>.json    the deployment: sizes, source, cuts
    traffic/<traffic>.json   the job mix: its job kind ("job"), sizes, and
                             how many warm-up jobs it needs
    jobs/<kind>.py           how a job kind makes its inputs from the seed,
                             runs one job through the port's entry, counts
                             its work and judges its answers
    cells/<cell>.json        the limits of the numbers `correct` compares
    metrics/<metric>.py      read(record) -> a number or None

A job is one whole run of a Bundler tool, and the window holds whole
jobs: after the warm-up, jobs start back to back while fewer than
`seconds` have passed since the first timed job began, and each runs to
its end.  The window runs from the first timed job's start to the last
one's end (it overruns `seconds` by less than one job), and rates are
all the window's work over its wall time.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "bundler_sfm_tpu")


class ForbiddenImport(RuntimeError):
    """The process holds JAX or the JAX package."""


def load_json(data_root: str, kind: str, name: str) -> Dict:
    with open(os.path.join(data_root, kind, name + ".json")) as f:
        return json.load(f)


def load_module(data_root: str, kind: str, name: str):
    """`<data_root>/<kind>/<name>.py` as a module (names may hold dots)."""
    path = os.path.join(data_root, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"sfmbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: Dict, workload: str) -> Dict:
    """The workload entry of `bench` and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {**cells[workload], "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated(device))


def _reset_peak(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench_path: str = "BENCHMARK.json",
             data_root: str = PKG, t_start: Optional[float] = None,
             log=sys.stderr) -> Dict:
    """One run; returns the result line's object (with `checks` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from bundler_sfm_tpu_torch.ops.matching import launch_counts
    from bundler_sfm_tpu_torch.utils.telemetry import get_telemetry

    from sfmbench.trace import Tracer

    with open(bench_path) as f:
        spec = cell_spec(json.load(f), workload)
    config = load_json(data_root, "configs", spec["config"])
    traffic = load_json(data_root, "traffic", spec["traffic"])
    limits = load_json(data_root, "cells", workload)["limits"]
    job = load_module(data_root, "jobs", traffic["job"])
    dev = torch.device(device)
    tel = get_telemetry()

    workdir = tempfile.mkdtemp(prefix="sfmbench_")
    try:
        t_prep = time.perf_counter()
        inputs = job.prepare(config, traffic, seed, workdir, dev)
        t_prep = time.perf_counter() - t_prep
        peak = _peak(dev)

        def one_job(k: int, tracer=None):
            job_dir = os.path.join(workdir, f"job{k}")
            os.makedirs(job_dir)
            tel.reset()
            _reset_peak(dev)
            before = launch_counts()
            _sync(dev)
            out = io.StringIO()
            t0, ns0 = time.perf_counter(), time.time_ns()
            try:
                with contextlib.redirect_stdout(out):
                    answer = job.run(inputs, job_dir, dev)
                _sync(dev)
                error = None
            except Exception:                   # one job's failure
                answer, error = None, traceback.format_exc()
            t1 = time.perf_counter()
            if tracer is not None:
                tracer.job(ns0, time.time_ns())
            rec = {"start_s": t0, "wall_s": t1 - t0,
                   "stages": dict(tel.stage_seconds),
                   "counters": dict(tel.counters), "peak_bytes": _peak(dev),
                   "launches": {n: c - before.get(n, 0)
                                for n, c in launch_counts().items()
                                if c != before.get(n, 0)}}
            if error:
                print(f"[sfmbench] job {k} failed:\n{error}\n"
                      f"{out.getvalue()[-2000:]}", file=log)
            return rec, answer

        warm = []
        for k in range(int(traffic.get("warmup_jobs", 1))):
            rec, answer = one_job(-1 - k)
            peak = max(peak, rec["peak_bytes"])
            warm.append(rec["wall_s"])
            if answer is None:
                raise RuntimeError("the warm-up job failed")
        print(f"[sfmbench] set-up: inputs {t_prep:.3f} s, warm-up "
              f"{warm} s", file=log)
        records, answers = [], []
        with Tracer(trace, dev, tel) as tracer:
            while True:
                rec, answer = one_job(len(records), tracer)
                records.append(rec)
                answers.append(answer)
                if time.perf_counter() - records[0]["start_s"] >= seconds:
                    break
        t_first = records[0]["start_s"]
        window_s = records[-1]["start_s"] + records[-1]["wall_s"] - t_first
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(
                f"after the window, sys.modules holds {', '.join(found)}")
        peak = max([peak] + [r["peak_bytes"] for r in records])
        traced = tracer.read()

        # The answers are judged after the window and the peak reading.
        good = [a for a in answers if a is not None]
        checks = job.judge(inputs, good, limits, seed, dev) if good else []
        failed = sum(a is None for a in answers)
        correct = bool(good) and failed == 0 and all(
            c["value"] <= c["limit"] for c in checks)
        for rec, answer in zip(records, answers):
            if answer is not None:
                rec.update(job.work(inputs, answer))

        record = {"setup_s": t_first - t_start, "window_s": window_s,
                  "jobs": records, "trace": traced}
        names = spec["per_layer"] if trace else spec["end_to_end"]
        metrics = {}
        for m in names:
            value = load_module(data_root, "metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": int(spec["chips"]), "memory_peak_bytes": peak}
        result = {"correct": correct, "attempted": len(answers),
                  "failed": failed, "metrics": metrics, "device": dev_rec}
        if traced:
            dev_rec["busy_s"] = traced["busy_s"]
            dev_rec["window_s"] = traced["window_s"]
            result["breakdown"] = {"device_ops": traced["device_ops"],
                                   "idle_gaps": traced["idle_gaps"]}
        for k, rec in enumerate(records):
            print(f"[sfmbench] job {k}: {rec['wall_s']:.4f} s, launches "
                  f"{json.dumps(rec['launches'])}, stages "
                  f"{json.dumps(rec['stages'])}", file=log)
        if traced:
            print(f"[sfmbench] trace: {traced['device_events']} device "
                  f"events ({traced['events_outside_window']} outside the "
                  f"window), kernels busy {traced['kernel_busy_s']} s",
                  file=log)
        # A number that could not be read (NaN) is written as null.
        result["checks"] = {
            c["name"]: {"value": c["value"] if c["value"] == c["value"]
                        else None, "limit": c["limit"]} for c in checks}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
