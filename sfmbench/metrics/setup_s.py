"""Process start to the first timed job's start: imports, the inputs
made and written, the warm-up job (and on a checkout's first run, the
kernels' build)."""


def read(record):
    return record["setup_s"]
