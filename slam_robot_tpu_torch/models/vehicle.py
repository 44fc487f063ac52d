"""Vehicle: batched dynamics for simulation and the host actuator shim.

Port of ``slam_robot_tpu/models/vehicle.py``. The reference's L0 layer
(vehicle.{h,cpp}, usb.h, the Maestro/SMC protocol headers) drives a Pololu
Maestro servo controller and a Simple Motor Controller over libusb. Here:

- protocol encoders (pure Python, this package's own copy): servo target =
  t*4*500 + 6000 (vehicle.cpp:36), motor speed = |s|*3200 with a direction
  flag (vehicle.cpp:58-67)
- ``step``: the bicycle model standing in for the physical car, float32
  over any leading batch shape (a fleet of rollouts is one batch)
- ``HostVehicle``: the host-side facade over a pluggable control-transfer
  transport, the reference's Vehicle: Turn(d) sets servo0=+d, servo1=-d
  (vehicle.cpp:112-115), Stop() zeroes everything and sets the USB kill
  (vehicle.cpp:98-104), and the destructor stops the car
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from slam_robot_tpu_torch.device import default_device

F32 = torch.float32

# ---- protocol encoders (maestro-protocol.h / smc-protocol.h semantics) ----

REQUEST_SET_TARGET = 0x85       # maestro-protocol.h:35-50
REQUEST_SET_SPEED = 0x90        # smc-protocol.h HpmcRequest
REQUEST_EXIT_SAFE_START = 0x91
REQUEST_SET_USB_KILL = 0x92
DIRECTION_FORWARD = 0
DIRECTION_REVERSE = 1


def maestro_target_value(target: float) -> int:
    """Servo PWM value for target in [-1,1]: t*4*500 + 6000
    (vehicle.cpp:36). 6000 = 1.5ms center in quarter-microseconds."""
    return int(round(target * 4 * 500 + 6000))


def smc_speed_value(speed: float) -> tuple[int, int]:
    """(magnitude 0..3200, direction) for speed in [-1,1]
    (vehicle.cpp:58-67)."""
    direction = DIRECTION_FORWARD
    if speed < 0:
        speed = -speed
        direction = DIRECTION_REVERSE
    return int(round(speed * 3200)), direction


# ---- batched dynamics (simulation stand-in) ----

class VehicleParams(NamedTuple):
    wheelbase: float = 0.26       # m (hobby-car scale)
    max_speed: float = 2.0        # m/s at |speed_cmd| = 1
    max_steer: float = 0.45       # rad at |turn_cmd| = 1
    speed_tau: float = 0.3        # s first-order speed lag


class VehicleState(NamedTuple):
    pos: torch.Tensor      # [..., 2] x, y (m)
    heading: torch.Tensor  # [...] rad
    speed: torch.Tensor    # [...] m/s


def init_state(x=0.0, y=0.0, heading=0.0, batch=(), device=None) -> VehicleState:
    """A state of leading shape ``batch`` at (x, y, heading), at rest, on
    ``device`` (default: the CUDA card, see ``device.default_device``)."""
    z = dict(dtype=F32, device=default_device(device))
    return VehicleState(
        pos=torch.stack([torch.full(batch, x, **z), torch.full(batch, y, **z)], dim=-1),
        heading=torch.full(batch, heading, **z),
        speed=torch.zeros(batch, **z),
    )


def step(state: VehicleState, speed_cmd, turn_cmd, dt: float = 0.05,
         params: VehicleParams = VehicleParams()) -> VehicleState:
    """Bicycle model: commands in [-1,1] use the same scaling the real
    actuators get (Turn/Speed, vehicle.cpp:107-115)."""
    z = dict(dtype=F32, device=state.speed.device)
    target_v = torch.clamp(torch.as_tensor(speed_cmd, **z), -1, 1) * params.max_speed
    alpha = min(max(dt / params.speed_tau, 0.0), 1.0)
    v = state.speed + (target_v - state.speed) * alpha
    steer = torch.clamp(torch.as_tensor(turn_cmd, **z), -1, 1) * params.max_steer
    heading = state.heading + v / params.wheelbase * torch.tan(steer) * dt
    pos = state.pos + (v * dt)[..., None] * torch.stack(
        [torch.cos(heading), torch.sin(heading)], dim=-1)
    return VehicleState(pos=pos, heading=heading, speed=v)


# ---- host shim ----

class HostVehicle:
    """The reference Vehicle facade over a pluggable control-transfer
    transport. transport(request, value, index) -> None; default logs."""

    def __init__(self, transport: Callable[[int, int, int], None] | None = None):
        self.log: list[tuple[int, int, int]] = []
        self.transport = transport or (lambda *a: self.log.append(a))
        # exit safe start + clear USB kill (PololuSMC::resume,
        # vehicle.cpp:73-80)
        self.transport(REQUEST_EXIT_SAFE_START, 0, 0)
        self.transport(REQUEST_SET_USB_KILL, 0, 0)

    def turn(self, d: float) -> None:
        """vehicle.cpp:112-115: servo0 = +d, servo1 = -d."""
        self.transport(REQUEST_SET_TARGET, maestro_target_value(d), 0)
        self.transport(REQUEST_SET_TARGET, maestro_target_value(-d), 1)

    def speed(self, s: float) -> None:
        value, direction = smc_speed_value(s)
        self.transport(REQUEST_SET_SPEED, value, direction)

    def stop(self) -> None:
        """vehicle.cpp:98-104 + USB kill."""
        self.turn(0.0)
        self.speed(0.0)
        self.transport(REQUEST_SET_USB_KILL, 1, 0)

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def emergency_stop(transport=None) -> None:
    """The ``stop`` binary (stop.cpp:3-6): construct a Vehicle, Stop()."""
    HostVehicle(transport).stop()
