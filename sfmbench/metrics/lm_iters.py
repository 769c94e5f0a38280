"""LM iterations a job (counter `lm_iters`)."""


def read(record):
    jobs = [j for j in record["jobs"] if "lm_iters" in j["counters"]]
    if not jobs:
        return None
    return sum(j["counters"]["lm_iters"] for j in jobs) / len(jobs)
