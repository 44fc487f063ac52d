"""Meshes and the observation-shard seam, sharded bundle adjustment,
rollout fleets, multi-robot shared maps and the multi-process dry run
(port of ``slam_robot_tpu/parallel``)."""
