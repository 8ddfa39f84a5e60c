"""Bytes and operations of the port's comm-embedding kernels
(``comm_embed_*``): one forward and one backward call over B rows and N
agents, each input read once and each output written once. The products
read the weights of the valid slots alone; the backward writes the
gradients of every slot (an empty slot's as zeros).

NeurComm's call reads obs [B, N, S], the fingerprints [B, N, A], the carry
[B, N, H] and the done flags [B]; DIAL's reads obs and its messages [B, N,
H] (H = n_msg) and has no fingerprint term (A = 0) and no done flags. The
terms of an agent: S + 1 own columns, and A + H for each of its neighbours.
Frozen here so that a change to the program cannot move them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from benchmark.roofline import ELEMENT_BYTES

Call = Tuple[float, float]


def embed_bytes_flops(comm: str, B: int, S: int, A: int, F: int, H: int,
                      degrees: Sequence[float], dtype: str
                      ) -> Tuple[Call, Call]:
    """((bytes, operations) of one forward call, (bytes, operations) of one
    backward call) of ``comm``'s embedding ("neurcomm" or "dial"; DIAL
    takes A = 0 whatever ``A`` says); ``degrees``: each agent's number of
    neighbours, K the largest."""
    if comm not in ("neurcomm", "dial"):
        raise ValueError(f"no comm-embedding kernel takes {comm!r}")
    es = ELEMENT_BYTES[dtype]
    masked = comm == "neurcomm"
    A = A if masked else 0
    N, K, edges = len(degrees), int(max(degrees)), float(sum(degrees))
    terms = N * (S + 1) + edges * (A + H)
    grads = N * (S + 1 + K * A + K * H) * F * es
    inputs = (B * N * (S + A + H) + (B if masked else 0)) * es
    act_f = B * N * F * es
    fwd = (inputs + terms * F * es + act_f, 2 * B * F * terms)
    # obs, fp, h, done, the valid W_msg, e, de in; dh and the weight
    # gradients out
    bwd = (inputs + edges * H * F * es + 2 * act_f + B * N * H * es + grads,
           2 * B * F * terms + 2 * B * edges * H * F)
    return fwd, bwd
