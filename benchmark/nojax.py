"""The run refuses JAX: nothing it loads may be JAX, jaxlib, flax or the
port's JAX original. Names are compared by their whole top-level part (the
text before the first dot), so ``deeprl_network_tpu_torch``, whose name
begins with the JAX package's, passes."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "deeprl_network_tpu"})


def offenders(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: what
    ``sys.modules`` holds now)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
