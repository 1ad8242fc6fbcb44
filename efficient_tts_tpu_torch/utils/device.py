"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for it
    on a host without a card raises rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    return dev


def check_module_device(module: torch.nn.Module, dev: torch.device) -> None:
    """Raise unless every tensor of `module` lies on `dev`."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.device.type != dev.type:
            raise ValueError(
                f"{type(module).__name__} holds tensors on {t.device}, "
                f"but the call asked for {dev}"
            )
