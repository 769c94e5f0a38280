"""Seconds a job in track building (`verify_tracks`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "verify_tracks")
