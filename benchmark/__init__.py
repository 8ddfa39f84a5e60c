"""The benchmark of the port ``deeprl_network_tpu_torch`` (see README.md
beside this file and ``BENCHMARK.json`` at the root)."""
