"""The benchmark of the PyTorch and CUDA port (`bundler_sfm_tpu_torch`).

    python3 -m sfmbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything particular to a cell sits in a file of its own, found by the
names in `BENCHMARK.json`: `configs/<config>.json` (the deployment),
`traffic/<traffic>.json` (the job mix, read by the job kind it names in
`jobs/<kind>.py`), `cells/<cell>.json` (the limits that decide
`correct`) and `metrics/<metric>.py` (one reader per metric).
"""
