"""Seconds a job adding new points and pruning bad ones (`add_points` +
`prune`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "add_points", "prune")
