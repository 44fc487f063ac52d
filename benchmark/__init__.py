"""The benchmark of ``slam_robot_tpu_torch``, the PyTorch and CUDA port.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON result line (README.md). Everything here is the yardstick:
the generator of inputs (``gen``), the plain reference (``reference``), the
comparison that decides ``correct`` (``compare``), the byte and operation
count (``roofline``), the trace reduction (``trace``) and one reader per
metric (``metrics``). From the port it takes the solver under test alone.
"""
