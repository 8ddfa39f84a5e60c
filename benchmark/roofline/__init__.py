"""The yardstick's counts: the card's published peaks, the bytes and
operations of the hand-written kernels from their shapes, and the model
FLOPs of an update from the published equations. Frozen here so that a
change to the program cannot move them.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W: 3.35 TB/s of
HBM, 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside the
tensor cores.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card can take: the larger of bytes over peak
    bandwidth and operations over the dtype's peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def cell_bytes_flops(B: int, N: int, F: int, H: int, dtype: str
                     ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((bytes, operations) of one forward call, (bytes, operations) of one
    backward call) of the per-agent LSTM cell over B rows and N agents, each
    input read once and each output written once (the forward on the train
    path also writes the masked carry it read, for the backward)."""
    es = ELEMENT_BYTES[dtype]
    G = 4 * H
    act_h, act_x = B * N * H * es, B * N * F * es
    weights = (N * F * G + N * H * G + N * G) * es
    done = B * es
    fwd_bytes = act_x + 2 * act_h + done + weights + 4 * act_h
    fwd_flops = 2 * B * N * (F + H) * G
    # backward: x, h_in, c_in, c_new, dc', dh', done, weights in; dx, dh,
    # dc_prev out, and the f32 weight gradients
    bwd_bytes = (act_x + 5 * act_h + done + weights
                 + act_x + 2 * act_h + (N * F * G + N * H * G + N * G) * 4)
    bwd_flops = 3 * fwd_flops   # gate recompute, [dx | dh], [dwx | dwh]
    return (fwd_bytes, fwd_flops), (bwd_bytes, bwd_flops)


def env_bytes_flops(B: int, L: int, M: int, P: int, D: int, W: int,
                    route_nnz: int, substeps: int, with_q0: bool
                    ) -> Tuple[int, int]:
    """(bytes, operations) of one control step of the ATSC engine over B
    rows in lockstep (one demand row): the state (queue, wait f32 [L],
    transit f32 [D, L], phase int64 [M], t int64, done, dropped f32) and the
    actions in, the static tables once (per lane its route row and column as
    3 index and 3 value pairs each, its delay slot, node, gate row of P,
    entry flag and route sum; per node its lane list and its obs gather and
    mask rows of W), the reset's queues where drawn; the state, obs, reward,
    done and six info sums out. Operations: per lane a substep two transit
    sums of D adds and about 25 more, and a multiply-add per route nonzero
    twice; the obs 2 M W."""
    state = B * (4 * L * (D + 2) + 8 * M + 8 + 1 + 4)
    tables = 4 * (L * (17 + P)
                  + (M + 1) + 2 * M * W + 2 * M)
    nbytes = (state - B + 8 * B * M + 4 * L + tables
              + (4 * B * L if with_q0 else 0)
              + state + B + 4 * B * (M * W + M + 6))
    flops = B * (substeps * (L * (2 * D + 25) + 4 * route_nnz) + 2 * M * W)
    return nbytes, flops


def comm_flops(comm: str, deg: float, n_a: int, F: int, H: int) -> float:
    """Model FLOPs of one agent-step's comm term (``reference/policy.py``),
    forward, from its matrix products: FP's fingerprint blocks, NeurComm's
    FP and message blocks over the deg neighbours, CommNet's shared map and
    the deg H adds of its mean, DIAL's message head and its message blocks
    (messages as wide as the embedding, F)."""
    if comm == "none":
        return 0.0
    if comm == "fp":
        return 2 * deg * n_a * F
    if comm == "neurcomm":
        return 2 * deg * n_a * F + 2 * deg * H * F
    if comm == "commnet":
        return 2 * H * F + deg * H
    if comm == "dial":
        return 2 * H * F + 2 * deg * F * F
    raise ValueError(f"unknown comm type {comm!r}")


def update_model_flops(B: int, T: int, n_s: int, n_a: int, F: int, H: int,
                       degrees, comm: str) -> float:
    """Model FLOPs of one A2C update of B envs over T steps: the policy's
    matrix products (own-obs embedding, the comm type's term, the LSTM
    cell, actor and critic) for every agent-step, forward and backward
    (twice the forward), and the bootstrap forward. No recompute, no env,
    no elementwise work."""
    per_agent = 0.0
    for deg in degrees:
        f = 2 * n_s * F + 2 * (F + H) * 4 * H + 2 * H * n_a + 2 * H
        f += comm_flops(comm, deg, n_a, F, H)
        per_agent += f
    return B * per_agent * (3 * T + 1)
