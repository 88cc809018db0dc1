"""The benchmark of `depth_estimation_torch` on one H100: a harness driven
by data (`BENCHMARK.json` at the repository's root, and the configurations,
traffic, per-layer metrics and limits under this folder), a plain reference
that decides `correct`, and the controls that show the comparison fails a
lower precision. Run one cell once with

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. Nothing here imports JAX or the JAX package.
"""
