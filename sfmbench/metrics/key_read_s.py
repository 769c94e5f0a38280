"""Seconds a job reading its key files: the job's wall time less the
`match` span (the rest of match_full is reading the files)."""


def read(record):
    jobs = [j for j in record["jobs"] if "match" in j["stages"]]
    if not jobs:
        return None
    return sum(j["wall_s"] - j["stages"]["match"] for j in jobs) / len(jobs)
