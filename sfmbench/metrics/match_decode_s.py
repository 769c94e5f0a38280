"""Seconds a job decoding the matcher's masked rows into match lists on
the host (span `match_decode`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "match_decode")
