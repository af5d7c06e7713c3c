"""The random streams that dropout draws from.

Counterpart of ``paddle_tpu/core/random.py`` (``seed``, ``next_key``,
``rng_guard``). The JAX package splits a host key for every random op and
routes the draws of a compiled step to fold-ins of the step's key
(``rng_guard``). The port draws from explicit ``torch.Generator``s on the
tensors' device, never from the global ``torch`` RNG:

* outside a training step, from a generator a device that :func:`seed`
  seeds (0 until it is called), made when a device is first met;
* inside ``TrainStep``, from the step's own generator (seeded by its
  ``seed=`` argument), which it installs with :func:`rng_guard` for the
  duration of each step.

:func:`generator` is what every draw asks for. The state is the
process's, not a thread's (the JAX package keeps it per thread): the
autograd engine runs a CUDA backward, and with it a recomputed block's
forward, on a thread of its own, which must draw from the generator the
step installed.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

import torch

__all__ = ["seed", "generator", "rng_guard"]


class _RNGState:
    def __init__(self):
        self.seed = 0
        self.defaults: Dict[torch.device, torch.Generator] = {}
        self.guarded = []           # generators installed by rng_guard


_state = _RNGState()


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(s: int) -> int:
    """Seed the default generators (those of draws outside a training
    step) with ``s``: every device's generator restarts from it."""
    _state.seed = int(s)
    for g in _state.defaults.values():
        g.manual_seed(_state.seed)
    return _state.seed


def generator(device) -> torch.Generator:
    """The generator a draw on ``device`` takes: the innermost
    :func:`rng_guard`'s when it lives on that device, else the device's
    default generator."""
    dev = _key(device)
    if _state.guarded and _state.guarded[-1].device == dev:
        return _state.guarded[-1]
    g = _state.defaults.get(dev)
    if g is None:
        g = _state.defaults[dev] = torch.Generator(device=dev).manual_seed(
            _state.seed)
    return g


@contextmanager
def rng_guard(gen: torch.Generator):
    """Route the draws on ``gen``'s device to ``gen`` inside the block."""
    _state.guarded.append(gen)
    try:
        yield gen
    finally:
        _state.guarded.pop()
