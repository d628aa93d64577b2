"""Full float32 products on the card.

The reference computes every float32 product in float32. On an H100 a
float32 `matmul` may take TF32 when `torch.backends.cuda.matmul.allow_tf32`
is on, which keeps 10 mantissa bits. The port's entry points that hold a
product to the reference (per-cell refinement, k-means distances, the
hsblock sweep) run it inside `full_f32_matmul()`, which turns TF32 off
for the block and restores the caller's setting after.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
