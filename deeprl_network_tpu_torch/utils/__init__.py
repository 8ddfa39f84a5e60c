from deeprl_network_tpu_torch.utils.scheduler import (  # noqa: F401
    Scheduler, make_schedule,
)
