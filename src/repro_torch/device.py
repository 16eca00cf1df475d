"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to
``"cuda"``. Asking for the card on a machine without one raises: there is
no silent fall back to the CPU, so a measurement or a verdict always
names the device it ran on. Only the tests pass ``device="cpu"``.
``"meta"`` is taken where a caller names it (the dry run,
``repro_torch.launch.dryrun``, builds and steps a model of shapes only);
nothing falls back to it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve(device: DeviceLike = "cuda") -> torch.device:
    """Validate ``device`` and return it as a ``torch.device``.

    Accepts ``"cpu"``, ``"meta"`` and ``"cuda"``/``"cuda:i"``; raises
    ``RuntimeError`` for a CUDA device that this process cannot see."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda is not "
                f"available (pass device='cpu' to run the plain versions)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}: "
                         f"expected 'cpu', 'meta' or 'cuda[:i]'")
    return dev


__all__ = ["DeviceLike", "resolve"]
