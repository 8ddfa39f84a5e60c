"""The cell op. Importing it builds and loads nothing: the kernels are
built at their first launch (``ops/_build.py``)."""

from deeprl_network_tpu_torch.ops.lstm_cell import fused_agent_lstm  # noqa: F401
