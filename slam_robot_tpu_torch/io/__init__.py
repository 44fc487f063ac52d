"""Host-side I/O: frame sources and the recorder (port of
``slam_robot_tpu/io``'s ``sources`` and ``recorder``), and the libusb
transport of the actuator shim (``usb``)."""
