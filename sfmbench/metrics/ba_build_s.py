"""Seconds a job assembling bundle-adjustment problems on the host and
uploading them (span `ba_build`, before each `ba`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "ba_build")
