"""The JAX repo's ``scripts/``, ported: the throughput tools
(``profile_step``: the cost of an update split into variants;
``bench_variants``: the lever sweeps) and the learning and evaluation
harnesses (``train_atsc`` with the hand-controller bar ``greedy_returns``,
``train_atsc_families``, ``ladder_atsc``, ``grid_demo``,
``train_cacc_families``, ``validate_learning``, ``slowdown_demo``,
``cacc_reward_decompose``). Each runs as
``python -m deeprl_network_tpu_torch.scripts.<name>``."""
