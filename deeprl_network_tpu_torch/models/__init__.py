"""The models' public names, as ``deeprl_network_tpu/models/__init__.py``
re-exports them; ``TF1RMSProp`` is the class ``tf1_rmsprop`` builds."""

from deeprl_network_tpu_torch.models.layers import (  # noqa: F401
    FCParams, LSTMParams, TF1RMSProp, fc_apply, fc_init, lstm_init,
    lstm_step, one_hot, ortho_init, tf1_rmsprop,
)
from deeprl_network_tpu_torch.models.policies import (  # noqa: F401
    AGENT_TO_COMM, Carry, CommType, PolicyParams, PolicySpec,
    consensus_update, init_carry, init_fingerprint, init_policy_params,
    mask_comm_params, policy_step,
)
from deeprl_network_tpu_torch.models.a2c import (  # noqa: F401
    LossStats, Rollout, a2c_loss, normalize_rewards, nstep_returns,
    spatial_mix,
)
