"""Hand-written CUDA kernels for Hopper (sources in ``slam_robot_tpu_torch/csrc``).

Counterpart of ``slam_robot_tpu/ops/pallas``: ``blur`` replaces the Pallas
separable blur, ``newton`` the fused Newton level kernel. Each module holds
the kernel's wrapper, its launch counter and its plain PyTorch version.
"""
