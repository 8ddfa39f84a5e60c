"""Environments of the port. Import the modules directly
(``deeprl_network_tpu_torch.envs.grid``); this file imports nothing."""
