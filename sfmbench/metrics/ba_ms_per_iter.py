"""Milliseconds of the `ba` span per LM iteration, over the window's
jobs."""


def read(record):
    iters = sum(j["counters"].get("lm_iters", 0) for j in record["jobs"])
    if not iters:
        return None
    return 1000.0 * sum(j["stages"].get("ba", 0.0)
                        for j in record["jobs"]) / iters
