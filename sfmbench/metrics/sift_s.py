"""Seconds a job in run_bundler's `sift` span: JPEG decode and
`extract_sift_batch`, which returns host arrays."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "sift")
