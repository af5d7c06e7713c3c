"""``cross_entropy`` (port of ``paddle_tpu/nn/functional/loss.py``).

The JAX function step by step, in PyTorch ops:

* ``logp`` = ``log_softmax(input)`` over ``axis`` (``use_softmax``), or
  ``log(max(input, 1e-30))`` of given probabilities;
* soft labels (``soft_label``, or a label of ``input``'s shape): ``-sum
  (label * logp)``, the label first smoothed to ``label * (1 - ls) + ls
  / C``;
* hard labels (int, ``[N]`` or ``[N, 1]`` along ``axis``): ``-logp`` at
  the label, ``(1 - ls) * picked + ls * mean(logp)`` with smoothing, 0
  where the label is ``ignore_index``; with a class ``weight`` each
  term times its class's weight;
* ``reduction="mean"`` over hard labels divides by the count of labels
  not ignored (at least 1), or with ``weight`` by the sum of their
  weights (at least 1e-12); ``"sum"`` sums, ``"none"`` keeps the terms.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input: torch.Tensor, label: torch.Tensor, weight=None,
                  ignore_index=-100, reduction="mean", soft_label=False,
                  axis=-1, use_softmax=True, label_smoothing=0.0
                  ) -> torch.Tensor:
    logp = torch.log_softmax(input, dim=axis) if use_softmax else \
        torch.log(torch.clamp_min(input, 1e-30))
    nc = input.shape[axis]
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape):
        soft = label.to(logp.dtype)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nc
        return _reduce(-(soft * logp).sum(dim=axis), reduction)
    li = label
    if li.dim() == input.dim() and li.shape[axis] == 1:
        li = li.squeeze(axis)
    li = li.long()
    valid = li != ignore_index
    safe = torch.where(valid, li, 0)
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        picked = (1 - label_smoothing) * picked + \
            label_smoothing * logp.mean(dim=axis)
    out = -torch.where(valid, picked, 0.0)
    if weight is not None:
        wv = torch.where(valid, weight[safe], 0.0)
        out = out * wv
        if reduction == "mean":
            return out.sum() / torch.clamp_min(wv.sum(), 1e-12)
    if reduction == "mean":
        return out.sum() / torch.clamp_min(valid.sum().to(out.dtype), 1.0)
    return _reduce(out, reduction)
