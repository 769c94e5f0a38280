"""Seconds a job writing verification's checkpoints: the `.prune`,
`.ransac` and `.corresp` match tables (span `match_snapshots`, the
`.corresp` walk over the tracks included) and `constraints.txt` (span
`write_constraints`)."""

from sfmbench.record import per_job_mean


def read(record):
    return per_job_mean(record, "match_snapshots", "write_constraints")
