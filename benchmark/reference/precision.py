"""Roundings that put the reference one precision below what a
configuration states, for the control of the correctness check: each takes
a float32 tensor and returns it rounded, still as float32, and the reference
applies it to every operand of its matrix products.

- ``tf32``: float32 with TF32 off is the stated precision; TF32 keeps 10 of
  float32's 23 mantissa bits (round to nearest even).
- ``fp8``: bfloat16 compute is the stated precision; float8 e4m3 with one
  scale a tensor (its largest magnitude onto 448, e4m3's largest number), as
  an fp8 matrix product is fed.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """float32 matrix products in full float32 (TF32 off) inside the
    block, whatever the process set."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _straight_through(t: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded`` in the forward pass; the gradient passes as through the
    identity, as the program's casts pass it."""
    return t + (rounded - t).detach()


def tf32(t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        bits = t.float().contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        bits = (bits + 0xFFF + lsb) & ~0x1FFF
        rounded = bits.view(torch.float32)
    return _straight_through(t, rounded)


def fp8(t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = 448.0 / t.float().abs().amax().clamp(min=1e-30)
        rounded = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return _straight_through(t, rounded)


ROUNDINGS = {"identity": identity, "tf32": tf32, "fp8": fp8}
# the control of each precision a configuration may state
BELOW = {"float32": "tf32", "bfloat16": "fp8"}
