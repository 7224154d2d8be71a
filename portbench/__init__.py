"""The benchmark of `lrf_tpu_torch` on NVIDIA GPUs: one cell of
`BENCHMARK.json` per run, `python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`."""
