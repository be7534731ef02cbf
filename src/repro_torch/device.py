"""Where the port's batched engines run.

Entry points take ``device=None``, which means the first CUDA device: the
port is written for the card.  A caller that wants the CPU asks for it
(``device="cpu"``), as the tests do; there the kernels' plain PyTorch
versions run instead of the CUDA kernels.  Asking for CUDA on a machine
without a card raises rather than quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
