"""The ranks of a hybrid-parallel run and their process groups.

Port of ``paddle_tpu/distributed/fleet/topology.py``:
:class:`CommunicateTopology` lays the ranks out on the named axes
(``data``, ``pipe``, ``sharding``, ``sep``, ``model`` in the order the
strategy gives, the last axis fastest), and
:class:`HybridCommunicateGroup` makes one process group for every line
of ranks along every axis of more than one rank, keeps the ones that
hold this rank, and answers the same queries as the JAX class (ranks,
world sizes, groups, source ranks, the pipeline stage and its p2p
neighbours).

Every rank makes every group, in the same order (``torch.distributed.
new_group`` is collective). An axis of one rank gets no group: its
``get_*_group()`` is None and nothing communicates over it. Without a
process group (one process that never called ``init_parallel_env``)
the world must be one rank, and every group is None.
"""
from __future__ import annotations

import collections
import itertools
import math

import torch.distributed as dist

from ..collective import new_group

__all__ = ["ParallelMode", "CommunicateTopology", "HybridCommunicateGroup"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    """Ranks on named axes: rank = the row-major index of its
    coordinates."""

    def __init__(self,
                 hybrid_group_names=("data", "pipe", "sharding", "sep",
                                     "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = collections.namedtuple(
            "Coordinate", self._parallel_names)
        self._world_size = math.prod(self._dims)
        all_coords = [self.coordinate(*c) for c in itertools.product(
            *[range(d) for d in self._dims])]
        self._coord2rank = {c: i for i, c in enumerate(all_coords)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **args):
        return self._coord2rank[self.coordinate(**args)]

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        """Every line of ranks along ``axis_name``: a list of rank
        lists, each in the axis's order."""
        axis = self._parallel_names.index(axis_name)
        others = [i for i in range(len(self._dims)) if i != axis]
        comm_list = []
        for other in itertools.product(*[range(self._dims[i])
                                         for i in others]):
            coord = [0] * len(self._dims)
            for i, o in zip(others, other):
                coord[i] = o
            ranks = []
            for v in range(self._dims[axis]):
                coord[axis] = v
                ranks.append(self._coord2rank[self.coordinate(*coord)])
            comm_list.append(ranks)
        return comm_list

    def get_fused_ranks(self, fused_axes):
        """The groups over the product of several axes (sorted rank
        lists)."""
        non_fused = [n for n in self._parallel_names if n not in fused_axes]
        comm_list = []
        for other in itertools.product(
                *[range(self.get_dim(n)) for n in non_fused]):
            ranks = []
            for fused in itertools.product(
                    *[range(self.get_dim(n)) for n in fused_axes]):
                kw = dict(zip(non_fused, other))
                kw.update(dict(zip(fused_axes, fused)))
                ranks.append(self.get_rank(**kw))
            comm_list.append(sorted(ranks))
        return comm_list


class HybridCommunicateGroup:
    """One process group an axis line (axes of more than one rank), the
    pipeline stage of this rank and its p2p neighbours."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.nranks = topology.world_size()
        if dist.is_initialized():
            if dist.get_world_size() != self.nranks:
                raise ValueError(
                    "the topology holds %d ranks, the process group %d"
                    % (self.nranks, dist.get_world_size()))
            self.global_rank = dist.get_rank()
        elif self.nranks == 1:
            self.global_rank = 0
        else:
            raise RuntimeError(
                "a topology of %d ranks needs the process group: call "
                "paddle_tpu_torch.distributed.init_parallel_env() (or "
                "fleet.init) in every rank first" % self.nranks)
        self._dp_degree = self._topo.get_dim("data")
        self._mp_degree = self._topo.get_dim("model")
        self._pp_degree = self._topo.get_dim("pipe")
        self._sharding_degree = self._topo.get_dim("sharding")
        self._sep_degree = self._topo.get_dim("sep")

        self._dp_group, self._dp_comm_group = self._set_comm_group("data")
        self._mp_group, self._mp_comm_group = self._set_comm_group("model")
        self._pp_group, self._pp_comm_group = self._set_comm_group("pipe")
        self._sharding_group, self._sharding_comm_group = \
            self._set_comm_group("sharding")
        self._sep_group, self._sep_comm_group = self._set_comm_group("sep")
        self._dp_sep_comm_group = self._set_fused_group(["data", "sep"]) \
            if self._sep_degree > 1 else self._dp_comm_group

        self._pp_prev_rank = self._pp_next_rank = None
        if self._pp_degree > 1:
            idx = self._pp_group.index(self.global_rank)
            n = len(self._pp_group)
            self._pp_next_rank = self._pp_group[(idx + 1) % n]
            self._pp_prev_rank = self._pp_group[(idx - 1) % n]

        self.stage_id = self._topo.get_coord(self.global_rank).pipe
        self._is_first_stage = self.stage_id == 0
        self._is_last_stage = self.stage_id == self._pp_degree - 1

    def _set_comm_group(self, axis_name):
        """(this rank's line of ranks along the axis, its group or
        None)."""
        mine, group = None, None
        for ranks in self._topo.get_comm_list(axis_name):
            grp = new_group(ranks) if len(ranks) > 1 else None
            if self.global_rank in ranks:
                mine, group = ranks, grp
        return mine, group

    def _set_fused_group(self, axes):
        group = None
        for ranks in self._topo.get_fused_ranks(axes):
            grp = new_group(ranks) if len(ranks) > 1 else None
            if self.global_rank in ranks:
                group = grp
        return group

    # ------------------------------------------------------------ queries
    def get_parallel_mode(self):
        if self._mp_degree == 1 and self._pp_degree == 1 and \
                self._sharding_degree == 1 and self._dp_degree > 1:
            return ParallelMode.DATA_PARALLEL
        if self._mp_degree > 1 and self._pp_degree == 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        return ParallelMode.DATA_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def _coord(self):
        return self._topo.get_coord(self.global_rank)

    # data parallel
    def get_data_parallel_rank(self):
        return self._coord().data

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_comm_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._coord().model

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_comm_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group[0]

    # pipeline parallel
    def get_stage_id(self):
        return self.stage_id

    def get_pipe_parallel_rank(self):
        return self._coord().pipe

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_comm_group

    def is_first_stage(self):
        return self._is_first_stage

    def is_last_stage(self):
        return self._is_last_stage

    def get_p2p_next_rank(self):
        return self._pp_next_rank

    def get_p2p_prev_rank(self):
        return self._pp_prev_rank

    # sharding
    def get_sharding_parallel_rank(self):
        return self._coord().sharding

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_comm_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group[0]

    # sep
    def get_sep_parallel_rank(self):
        return self._coord().sep

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_comm_group

    def get_dp_sep_parallel_group(self):
        return self._dp_sep_comm_group
