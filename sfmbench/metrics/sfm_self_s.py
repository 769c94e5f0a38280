"""Seconds a job in stage 5's `total` span outside the spans directly
inside it: the incremental loop's own host time between its steps.

`CHILDREN` are the spans that `pipeline/incremental.py::bundle_adjust_fast`
opens directly inside `total`; none of them holds another, so their
seconds add up without overlap.  Only jobs that have `ba_build` are read:
a program without that span leaves host steps inside `total` unnamed.
"""

CHILDREN = ("init_pair", "ba_build", "ba", "ba_apply", "fix_necker",
            "candidates", "register", "add_points", "prune", "round_outputs",
            "estimate_ignored", "write_bundle")


def read(record):
    jobs = [j["stages"] for j in record["jobs"]
            if "total" in j["stages"] and "ba_build" in j["stages"]]
    if not jobs:
        return None
    return sum(s["total"] - sum(s.get(c, 0.0) for c in CHILDREN)
               for s in jobs) / len(jobs)
