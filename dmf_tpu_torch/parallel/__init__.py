"""The device mesh (``mesh``), its state placement and SPMD step
(``sharding``), the tensor-parallel layers of its model axis (``tensor``)
and fold-parallel training (``multifold``), counterpart of
``dmf_tpu/parallel``."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, RowShard, active_shard, auto_mesh_shape,
                   local_mesh, make_mesh, mesh_from_config, shard_rows)
from .multifold import (index_fold_state, make_multifold_predictor, make_multifold_step,
                        stack_fold_batches, stack_fold_states)
from .sharding import (full_state_dict, make_spmd_step, param_spec, reduce_gradients,
                       replicate_state, shard_state, state_shardings)
from .tensor import tensor_parallel

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "RowShard", "active_shard", "auto_mesh_shape",
           "local_mesh", "make_mesh", "mesh_from_config", "shard_rows",
           "index_fold_state", "make_multifold_predictor", "make_multifold_step",
           "stack_fold_batches", "stack_fold_states",
           "full_state_dict", "make_spmd_step", "param_spec", "reduce_gradients",
           "replicate_state", "shard_state", "state_shardings", "tensor_parallel"]
