"""Share of the window's LM iterations that ran as CUDA graph replays
(counter `ba_graph_iters` over counter `lm_iters`, in %); None where no
job has the counter."""


def read(record):
    jobs = record["jobs"]
    if not any("ba_graph_iters" in j["counters"] for j in jobs):
        return None
    iters = sum(j["counters"].get("lm_iters", 0) for j in jobs)
    if not iters:
        return None
    return 100.0 * sum(j["counters"].get("ba_graph_iters", 0)
                       for j in jobs) / iters
