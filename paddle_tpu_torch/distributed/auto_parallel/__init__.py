"""The mesh, the sharding annotations and the semi-auto surface of the
port's sharded training (see :mod:`..sharding`)."""
from .api import (dtensor_from_local, local_value, reshard, shard_tensor,
                  unshard_dtensor)
from .constraint import (annotate_param, filtered_spec, param_spec,
                         shard_activation)
from .placement_type import Partial, Placement, Replicate, Shard
from .process_mesh import ProcessMesh, get_mesh, set_mesh

__all__ = ["ProcessMesh", "get_mesh", "set_mesh", "annotate_param",
           "filtered_spec", "param_spec",
           "shard_activation", "Placement", "Shard", "Replicate", "Partial",
           "shard_tensor", "dtensor_from_local", "reshard",
           "unshard_dtensor", "local_value"]
