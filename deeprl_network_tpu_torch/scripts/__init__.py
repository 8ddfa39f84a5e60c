"""The JAX repo's throughput tools, ported: ``profile_step`` (the cost of an
update split into variants) and ``bench_variants`` (the lever sweeps). Each
runs as ``python -m deeprl_network_tpu_torch.scripts.<name>``."""
