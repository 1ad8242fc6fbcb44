"""Full f32 on the card (counterpart of XLA's f32 and Precision.HIGHEST)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Within the context cuBLAS and cuDNN compute f32 products and
    convolutions without TF32, as the JAX reference computes them; the
    previous settings come back on exit. The hand-written kernels state
    their own precision."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
