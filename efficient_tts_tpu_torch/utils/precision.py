"""Full f32 on the card (counterpart of XLA's f32 and Precision.HIGHEST)."""

from __future__ import annotations

import contextlib
import threading

import torch

# The TF32 flags are process-wide, so the context is counted across threads:
# the first thread in saves and clears them, the last one out restores them.
_lock = threading.Lock()
_depth = 0
_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def full_f32():
    """Within the context cuBLAS and cuDNN compute f32 products and
    convolutions without TF32, as the JAX reference computes them. The flags
    stay off while any thread is inside; the settings from before the first
    entry come back when the last one leaves. The hand-written kernels state
    their own precision."""
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _saved
