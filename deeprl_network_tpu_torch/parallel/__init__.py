"""Data parallelism over ``torch.distributed``.

``maybe_initialize`` stands where the JAX package exports ``make_mesh``: the
process group is the port's counterpart of a device mesh. ``make_parallel_a2c``
and ``ParallelA2C`` load on first access, because ``parallel/train.py``
imports ``utils/rollout.py``, which imports ``parallel/distributed.py``:
an eager import here would be a cycle.
"""

from deeprl_network_tpu_torch.parallel.distributed import (  # noqa: F401
    maybe_initialize,
)

_TRAIN_NAMES = ("make_parallel_a2c", "ParallelA2C")


def __getattr__(name):
    if name in _TRAIN_NAMES:
        from deeprl_network_tpu_torch.parallel import train
        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
