"""Device selection: the port never picks a device by itself.

``None`` means the CUDA card. The CPU runs only when a caller names it
(``device="cpu"``), and then every kernel wrapper takes its plain PyTorch
version because its tensors lie on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and ``torch.cuda.is_available()`` is False, when its index
    is past the machine's cards, and (from ``torch.device``) for a name
    torch cannot parse.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"no CUDA device {dev.index}: this machine has "
            f"{torch.cuda.device_count()}"
        )
    return dev
