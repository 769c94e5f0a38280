"""Seconds a job in the `match` span: the descriptor table's upload
and match_pairs, host arrays returned."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "match")
