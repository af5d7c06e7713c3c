"""The optimizer of a hybrid-parallel run.

Port of ``paddle_tpu/distributed/fleet/hybrid_parallel_optimizer.py``:
:class:`HybridParallelOptimizer` wraps an eager optimizer of the port
(``AdamW`` / ``SGD`` built with ``parameters=``) and

- replaces a ``ClipGradByGlobalNorm`` ``grad_clip`` by
  :class:`_HybridClip`, whose squared norm is the whole model's: the
  mp-split gradients' (``is_distributed``) summed over the
  model-parallel group, the others' (the same on every mp rank) added
  once, the total summed over the pipeline's stages and over the
  sharding group (each sharding rank clips the part it owns);
- where the sharding axis has more than one rank, wraps the optimizer in
  the stage-1 :class:`~.sharding_optimizer.DygraphShardingOptimizer`
  over the sharding group at the first ``step()`` (before the inner
  optimizer makes its state), unless it is a sharding optimizer already
  (``fleet.distributed_optimizer``'s stage 2);
- hands ``AdamW`` the model-parallel group of each mp-split parameter
  (``shards``: the rows' group for ``split_axis`` 0, the columns' for
  1), so a factored second moment keeps the whole matrix's row and
  column statistics, as on one process;
- with ``strategy.gradient_merge`` applies the update every
  ``k_steps``-th ``step()`` only, the gradients accumulated in between
  (``clear_grad`` waits with them) and, with ``avg`` (the default),
  averaged over the k.

``HybridParallelGradScaler`` waits for an amp port (``ROADMAP.md``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...nn.clip import ClipGradByGlobalNorm
from ...optimizer.optimizers import grad_of
from .mp_layers import is_distributed
from .sharding_optimizer import DygraphShardingOptimizer

__all__ = ["HybridParallelOptimizer"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._sharding_enable = \
            hcg.get_sharding_parallel_world_size() > 1
        self._gm_k, self._gm_avg, self._gm_count = 1, True, 0
        if strategy is not None and strategy.gradient_merge:
            self._gm_k = int(strategy.gradient_merge_configs.get(
                "k_steps", 1))
            self._gm_avg = bool(strategy.gradient_merge_configs.get(
                "avg", True))
        # the eager optimizer itself (stage 2 wraps it already), and the
        # whole parameter list: a sharding wrapper cuts the inner one to
        # its part, but the merge's average scales every rank's gradients
        base = optimizer._inner_opt if isinstance(
            optimizer, DygraphShardingOptimizer) else optimizer
        params = optimizer._all_params if base is not optimizer else list(
            getattr(optimizer, "_parameter_list", None) or ())
        self._gm_params = params
        clip = getattr(base, "_grad_clip", None)
        if isinstance(clip, ClipGradByGlobalNorm):
            base._grad_clip = _HybridClip(
                clip, hcg, params[0].device if params else None)
        mp = hcg.get_model_parallel_group()
        if mp is not None and hasattr(base, "_shards"):
            base._shards = [
                ((mp, None) if p.split_axis == 0 else (None, mp))
                if is_distributed(p) else (None, None)
                for p in base._parameter_list]

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        if self._gm_k > 1:
            self._gm_count += 1
            if self._gm_count % self._gm_k:
                return          # accumulate; clear_grad waits too
            if self._gm_avg:
                with torch.no_grad():
                    for p in self._gm_params:
                        g = grad_of(p)
                        if g is not None:
                            g.mul_(1.0 / self._gm_k)
        if self._sharding_enable:
            if not isinstance(self._inner_opt, DygraphShardingOptimizer):
                self._inner_opt = DygraphShardingOptimizer(
                    self._inner_opt, self._hcg)
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=False):
        if self._gm_k > 1 and self._gm_count % self._gm_k:
            return              # mid-merge: keep the accumulated grads
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()
        return None, None


class _HybridClip:
    """Global-norm clip whose squared norm spans the model-, pipeline-
    and sharding-parallel groups, so every rank clips by the whole
    model's norm."""

    def __init__(self, clip: ClipGradByGlobalNorm, hcg, device):
        self._clip = clip
        self._hcg = hcg
        self._device = device

    def __call__(self, params_grads):
        params_grads = list(params_grads)
        split = [(p, g) for p, g in params_grads
                 if is_distributed(p)]
        whole = [(p, g) for p, g in params_grads
                 if not is_distributed(p)]
        # every rank joins the all-reduces, one whose part has no
        # gradient too
        dev = next((g.device for _, g in params_grads if g is not None),
                   self._device)
        dist_sq = ClipGradByGlobalNorm.global_norm_sq(split).to(dev)
        mp = self._hcg.get_model_parallel_group()
        if mp is not None:
            dist.all_reduce(dist_sq, group=mp)
        total = dist_sq + ClipGradByGlobalNorm.global_norm_sq(whole).to(dev)
        for group in (self._hcg.get_pipe_parallel_group(),
                      self._hcg.get_sharding_parallel_group()):
            if group is not None:
                dist.all_reduce(total, group=group)
        return self._clip.scaled(params_grads, total)
