"""Activation recompute for the eager fleet path.

Port of ``paddle_tpu/distributed/fleet/recompute.py``: ``recompute(fn,
*args)`` keeps only ``fn``'s inputs and runs it again in the backward
(non-reentrant ``torch.utils.checkpoint``, which ``torch.autograd.grad``
accepts, as the pipeline schedules need); ``recompute_sequential``
cuts a list of layers into segments, each recomputed.

The port's dropout draws from explicit generators
(:mod:`paddle_tpu_torch.core.random`), which ``torch.utils.checkpoint``
does not stash. With ``preserve_rng_state`` (the default) the
generator of the inputs' device is read before the forward; the
recompute runs from that state, with that generator installed (it runs
on the autograd engine's thread), and then puts back the generator's
state of the moment, so it draws the forward's masks and the draws
after it see the same stream with recompute on or off (as
``models/gpt.py`` ``GPTBlock._replaying`` does for a block).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ...core import random as _random

__all__ = ["recompute", "recompute_sequential"]


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _replaying(function, device):
    """``function`` whose calls after the first draw the first call's
    dropout masks again."""
    gen = _random.generator(device)
    start = gen.get_state()
    first = True

    def body(*args):
        nonlocal first
        if first:
            first = False
            return function(*args)
        now = gen.get_state()
        gen.set_state(start)
        try:
            with _random.rng_guard(gen):
                return function(*args)
        finally:
            gen.set_state(now)
    return body


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations rebuilt in the
    backward. Keywords ``preserve_rng_state`` (default True: the
    recompute draws the forward's dropout masks) and ``use_reentrant``
    (accepted; the port always runs the non-reentrant form) are the
    recompute's own; the rest go to ``function``."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    fn = (lambda *a: function(*a, **kwargs)) if kwargs else function
    if preserve:
        fn = _replaying(fn, _device_of(args))
    return checkpoint(fn, *args, use_reentrant=False)


def recompute_sequential(ctx, functions, *args):
    """``functions`` (a sequence of layers) applied in turn to
    ``args``, cut into ``ctx["segments"]`` segments (one by default),
    each under :func:`recompute`."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    n = len(layers)
    per = max(n // segments, 1)
    x = args[0] if len(args) == 1 else args

    def run_segment(start, end):
        def seg_fn(inp):
            for layer in layers[start:end]:
                inp = layer(inp)
            return inp
        return seg_fn

    for start in range(0, n, per):
        x = recompute(run_segment(start, min(start + per, n)), x)
    return x
