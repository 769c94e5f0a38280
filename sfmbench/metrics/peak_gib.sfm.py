"""Peak device memory of a job (torch.cuda.max_memory_allocated, reset
before each job), the largest over the window's jobs, in GiB."""


def read(record):
    peak = max((j["peak_bytes"] for j in record["jobs"]), default=0)
    return peak / 2 ** 30 if peak else None
