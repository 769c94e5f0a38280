"""Seconds a job reading its key files and centring their keypoints (span
`load_keys` of `bundler.py::scene_from_args`, one an image)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "load_keys")
