"""slam_robot_tpu_torch — the SLAM system of ``slam_robot_tpu`` in PyTorch.

A port of the JAX package's main path (``models/pipeline.step``) and its
replay driver (``run_replay``) to PyTorch, with hand-written CUDA kernels for
Hopper (``csrc/``) in place of the package's two Pallas kernels. The layout
mirrors ``slam_robot_tpu``:

- ``config``    ``SlamConfig``, this package's own copy of the JAX package's
- ``ops``       geometry, pyramids, patches, the fused tracker, corners, BA
- ``ops/cuda``  kernel wrappers (counterpart of ``ops/pallas``) and the
                ``nvcc`` build of ``csrc/*.cu``
- ``models``    map state, matcher, BA windows, the pipeline step, renderer
- ``io``        frame sources and the recorder
- ``utils``     intrinsics, the bench scene, map dumps and trajectory
                errors, metrics, debug drawing, checkpoints
- ``bridge``    conversion of JAX-package states (as numpy) to and from
                this package's tensors
- ``run_replay`` the replay driver (``python -m slam_robot_tpu_torch.run_replay``)

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(``device.default_device``). This package imports neither JAX nor anything
of ``slam_robot_tpu``.
"""

__version__ = "0.1.0"

from slam_robot_tpu_torch.config import REFERENCE_EXACT_KW, SlamConfig  # noqa: F401
