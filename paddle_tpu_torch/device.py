"""Device resolution for every entry point of the port.

The port runs on a CUDA device unless the caller asks for the CPU by
name. It never falls back to the CPU on its own: a missing GPU is an
error, so a run that was meant for the card cannot quietly measure the
host instead.

:func:`set_device` / :func:`get_device` are Paddle's global place (port
of ``paddle_tpu/device/__init__.py``): ``set_device("cpu")`` makes the
CPU the default of every entry point that is given no device
(``to_tensor``, the eager layers, ``DataLoader``, the models);
``"gpu"`` / ``"gpu:1"`` / ``"cuda:1"`` a card. Until it is called the
default is ``cuda``.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "set_device", "get_device"]

DeviceLike = Union[str, torch.device, None]

_current: DeviceLike = None         # set_device's place; None: cuda


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means :func:`set_device`'s place, else ``cuda`` (the
    current CUDA device). ``"cpu"`` is taken only when asked for. Raises
    ``RuntimeError`` when a CUDA device is wanted and none is present."""
    if device is None:
        device = _current
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError("paddle_tpu_torch runs on 'cuda' or 'cpu', "
                         "not %r" % (str(dev),))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or call "
            "set_device('cpu')) to run the plain PyTorch path on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_device(device: DeviceLike) -> torch.device:
    """Make ``device`` (``"cpu"``, ``"gpu"``, ``"gpu:n"``, ``"cuda:n"`` or
    a ``torch.device``) the default of every entry point; returns it.
    A card that is not present raises here, not at first use.
    ``None`` restores the default, ``cuda``."""
    global _current
    dev = None if device is None else resolve_device(device)
    _current = dev
    return dev


def get_device() -> str:
    """The default place in Paddle's spelling: ``"cpu"`` or ``"gpu:n"``.
    Raises when it is a card and none is present."""
    dev = resolve_device(None)
    return "cpu" if dev.type == "cpu" else "gpu:%d" % dev.index
