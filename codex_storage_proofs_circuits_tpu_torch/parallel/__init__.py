"""Sharded builds over device meshes, in one process or several
(torch.distributed): the port of codex_storage_proofs_circuits_tpu/parallel/.

Cells shard across the devices of a mesh row, each shard builds its
subtree, one node a shard crosses to the row's device for the top layers,
and slots shard over the rows; their roots meet in the dataset tree.
"""

from .mesh import Mesh, cells_axis, make_mesh, slots_axis
from .tree import join, sharded_dataset_build, sharded_dataset_build_rows, sharded_slot_tree_layers
from .gl_tree import sharded_gl_dataset_build, sharded_gl_dataset_build_rows
from .proof_input import sharded_gl_proof_input, sharded_proof_input
