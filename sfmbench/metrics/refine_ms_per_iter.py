"""Milliseconds of the `refine_camera` span per lockstep LM iteration
(counter `refine_lm_iters`), over the window's jobs."""


def read(record):
    iters = sum(j["counters"].get("refine_lm_iters", 0)
                for j in record["jobs"])
    if not iters:
        return None
    return 1000.0 * sum(j["stages"].get("refine_camera", 0.0)
                        for j in record["jobs"]) / iters
