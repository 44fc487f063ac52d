"""slam_robot_tpu_torch — the SLAM step of ``slam_robot_tpu`` in PyTorch.

A port of the JAX package's main path (``models/pipeline.step``) to PyTorch,
with hand-written CUDA kernels for Hopper (``csrc/``) in place of the
package's two Pallas kernels. The layout mirrors ``slam_robot_tpu``:

- ``ops``       geometry, pyramids, patches, the fused tracker, corners, BA
- ``ops/cuda``  kernel wrappers (counterpart of ``ops/pallas``) and the
                ``nvcc`` build of ``csrc/*.cu``
- ``models``    map state, matcher, BA windows, the pipeline step, renderer
- ``utils``     synthetic intrinsics, the bench scene, trajectory alignment
- ``bridge``    conversion of JAX-package states (as numpy) to and from
                this package's tensors

Configuration is shared: ``SlamConfig`` comes from ``slam_robot_tpu.config``,
which imports no JAX. This package never imports JAX.
"""

__version__ = "0.1.0"

from slam_robot_tpu.config import REFERENCE_EXACT_KW, SlamConfig  # noqa: F401
