"""Seconds a job reading its key files (span `read_keys` of
`keymatch.match_full`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "read_keys")
