"""Where the port's tensors live.

Every entry point takes a ``device`` argument and places its tensors on
``cuda`` unless the caller asks for ``"cpu"`` (as the CPU tests do).  With
no GPU and no explicit ``device="cpu"`` the entry points raise: the port
never falls back to the host silently.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_graph_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


def check_graph_device(graph, device: str | torch.device | None
                       ) -> torch.device:
    """An engine's device check: ``device`` resolved as above, and the
    graph must live there (a bare ``cuda`` matches any CUDA index)."""
    device = resolve_device(device)
    if graph.device != device and not (
            device.type == graph.device.type == "cuda" and device.index is None):
        raise ValueError(f"graph lives on {graph.device}, run asked for "
                         f"{device}")
    return device
