"""Environments of the port: the base classes and the CACC platoon, as the
JAX package's ``envs/__init__.py`` re-exports them. The ATSC envs are
imported from their modules (``deeprl_network_tpu_torch.envs.grid``,
``.monaco``)."""

from deeprl_network_tpu_torch.envs.base import Env, EnvSpec  # noqa: F401
from deeprl_network_tpu_torch.envs.cacc import CACCEnv  # noqa: F401
