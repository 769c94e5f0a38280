"""Seconds a job reading its images' sizes and sampling the JPEGs'
colours at the keypoints (span `key_colors` of
`bundler.py::scene_from_args`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "key_colors")
