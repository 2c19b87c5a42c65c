"""The distributed layer: rank meshes and the programs sharded over them.

Port of slam_framework_tpu/parallel/: a `jax.sharding.Mesh` with `shard_map`
programs becomes a rank mesh (`mesh.LocalMesh`, threads of one process on one
device; `multihost.ProcessMesh`, one process per rank over torch.distributed)
running the unchanged single-device optimizers with their `allreduce=` hook:
the sharded global BA (`dist_ba`), the edge-sharded pose graph
(`dist_pose_graph`), and the covisibility-segment partition with point
migration (`map_shard`).
"""

from slam_framework_torch.parallel.mesh import LocalMesh, RankMesh

__all__ = ["LocalMesh", "RankMesh"]
