"""Seconds a job reading its match source, `matches.init.txt` under
RunBundler.sh's options (span `read_matches` of
`bundler.py::scene_from_args`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "read_matches")
