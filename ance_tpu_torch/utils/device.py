"""Device resolution: the port never falls back from CUDA to the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` → a ``torch.device``.

    Asking for CUDA where none exists raises ``SystemExit``: a serving
    process that quietly ran on the CPU would answer, slowly, under a
    device label it does not have. ``cpu`` is for the CPU tests."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: CUDA is not available "
                             "(pass --device cpu only for CPU tests)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise SystemExit(f"--device {name}: only "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise SystemExit(f"--device {name}: expected cuda[:N] or cpu")
    return dev
