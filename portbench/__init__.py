"""portbench: the benchmark of theoremsearch_tpu_torch on one H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once and prints one JSON line. Everything that belongs to one
configuration, traffic mix, cell or per-layer metric is a file of its own,
found by its name: `configs/<config>.json`, `traffic/<mix>.json`,
`workloads/<cell>.json`, `loops/<loop>.py`, `metrics/<metric>.py`.
Nothing here imports jax or the JAX package; `reference/` imports nothing
of the port either.
"""
