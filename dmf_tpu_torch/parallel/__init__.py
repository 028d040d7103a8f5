"""The device mesh's data axis (``mesh``, ``sharding``) and fold-parallel
training (``multifold``), counterpart of ``dmf_tpu/parallel``; the model
axis (``param_spec``, ``state_shardings``) waits for ROADMAP 1.13b."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, RowShard, active_shard, auto_mesh_shape,
                   local_mesh, make_mesh, mesh_from_config, shard_rows)
from .multifold import (index_fold_state, make_multifold_predictor, make_multifold_step,
                        stack_fold_batches, stack_fold_states)
from .sharding import make_spmd_step, reduce_gradients, shard_state

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "RowShard", "active_shard", "auto_mesh_shape",
           "local_mesh", "make_mesh", "mesh_from_config", "shard_rows",
           "index_fold_state", "make_multifold_predictor", "make_multifold_step",
           "stack_fold_batches", "stack_fold_states",
           "make_spmd_step", "reduce_gradients", "shard_state"]
