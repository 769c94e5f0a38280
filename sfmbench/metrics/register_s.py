"""Seconds a job registering new cameras: batched resection and the
lockstep refine (`register`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "register")
