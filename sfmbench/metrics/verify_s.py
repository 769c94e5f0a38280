"""Seconds a job in F-matrix and homography verification."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "verify_fmatrix", "verify_homography")
