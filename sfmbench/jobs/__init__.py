"""Job kinds: how a traffic mix's jobs make their inputs, call the port,
count their work and are judged.  Each module defines

    prepare(config, traffic, seed, workdir, device) -> inputs
    run(inputs, job_dir, device) -> answer       (the timed job)
    work(inputs, answer) -> {quantity: number}   (read by the metrics)
    judge(inputs, answers, limits, seed, device) -> [{name, value, limit}]
    control*(inputs, job_dir, device, seed) -> answer
                     (the controls `sfmbench/control.py` reads; `control`
                     is the lower-precision one)
"""
