"""Lockstep LM iterations the refine of new cameras ran a job (counter
`refine_lm_iters`, one a pass of `ops/lm.py::camera_refine_batch`'s loop
that did work)."""


def read(record):
    jobs = [j for j in record["jobs"] if "refine_lm_iters" in j["counters"]]
    if not jobs:
        return None
    return sum(j["counters"]["refine_lm_iters"] for j in jobs) / len(jobs)
