"""PyTorch/CUDA port of the asynch-SGBDT system (``repro`` is the JAX reference).

Module names mirror ``repro`` so each counterpart is easy to find. Entry
points run on the card unless the caller passes ``device="cpu"``; on a
CUDA tensor every kernel wrapper launches its hand-written kernel, on a
CPU tensor it runs the kernel's plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given.

    Without a ``device`` and without a GPU this raises: the port never
    carries on quietly on the CPU. A CUDA device comes back with its index
    (``cuda:0``), as tensors report theirs.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
