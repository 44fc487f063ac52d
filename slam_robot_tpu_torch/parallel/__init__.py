"""Device meshes and data-parallel rollout fleets (port of
``slam_robot_tpu/parallel``'s ``mesh`` and ``rollouts``)."""
