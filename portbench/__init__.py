"""portbench: the benchmark of gabby_tpu_torch on one NVIDIA H100.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` serves one cell of BENCHMARK.json through the port's
engine and prints one JSON result line. Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own,
found by the name BENCHMARK.json gives it: `configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py`.

Nothing here imports JAX or the JAX package `gabby_tpu`; the plain
reference in `reference/` imports nothing of the port either.
"""
