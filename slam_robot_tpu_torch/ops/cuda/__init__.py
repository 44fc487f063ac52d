"""Hand-written CUDA kernels for Hopper (sources in ``slam_robot_tpu_torch/csrc``).

Counterpart of ``slam_robot_tpu/ops/pallas``: ``blur`` replaces the Pallas
separable blur, ``newton`` the fused Newton level kernel. The ``probe_*``
modules replace the Mosaic probes' kernels of the JAX package's ``tools/``
(driven by ``slam_robot_tpu_torch.tools``). Each module holds its kernels'
wrappers, their launch counters and their plain PyTorch versions.
"""
