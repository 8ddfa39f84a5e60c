"""deeprl_network_tpu_torch: the PyTorch/CUDA port of ``deeprl_network_tpu``.

It mirrors the JAX package's layout (``envs/ models/ ops/ utils/``) and
computes the same functions: the JAX package is the reference, and
``tests/test_torch_*.py`` hold each module against it. The port imports
``torch`` and ``numpy`` only. Its entry points take a ``device`` argument
that defaults to ``"cuda"`` and raise when no card is present unless the
caller asks for ``device="cpu"``. On a CUDA device the per-agent LSTM cell
runs as hand-written Hopper kernels (``ops/csrc/lstm_cell.cu``).
"""

__version__ = "0.1.0"
