"""The port's vehicle (``models/vehicle``), its libusb transport
(``io/usb``) and the emergency-stop CLI (``stop``) against the JAX
package's.

Tolerances: the protocol encoders, the host shim's transfer logs and the
stop line are compared exactly (integers and strings). ``step`` atol 1e-6
on 256 seeded states with positions within 5 m (float32 spacing there is
4.8e-7; the two packages' cos, sin and tan differ by an ulp).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu import stop as j_stop
from slam_robot_tpu.models import vehicle as jv
from slam_robot_tpu_torch import stop as t_stop
from slam_robot_tpu_torch.io import usb as t_usb
from slam_robot_tpu_torch.models import vehicle as tv
from tests.test_torch_config import ROOT

GRID = np.concatenate([np.linspace(-1.0, 1.0, 801), [0.18, -0.18, 0.75, -0.75, 0.00025]])


def test_protocol_constants_match():
    for name in ("REQUEST_SET_TARGET", "REQUEST_SET_SPEED", "REQUEST_EXIT_SAFE_START",
                 "REQUEST_SET_USB_KILL", "DIRECTION_FORWARD", "DIRECTION_REVERSE"):
        assert getattr(tv, name) == getattr(jv, name), name
    assert tv.VehicleParams() == tuple(jv.VehicleParams())
    for name in ("POLOLU_VENDOR", "MAESTRO_PRODUCTS", "SMC_PRODUCTS"):
        from slam_robot_tpu.io import usb as j_usb

        assert getattr(t_usb, name) == getattr(j_usb, name), name


@pytest.mark.parametrize("encoder", ["maestro_target_value", "smc_speed_value"])
def test_encoders_match_over_a_grid(encoder):
    for x in GRID:
        assert getattr(tv, encoder)(float(x)) == getattr(jv, encoder)(float(x)), x


def _seeded_states(n=256, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(pos=rng.uniform(-5, 5, (n, 2)).astype(f),
                heading=rng.uniform(-2 * np.pi, 2 * np.pi, n).astype(f),
                speed=rng.uniform(-2, 2, n).astype(f),
                speed_cmd=rng.uniform(-1.5, 1.5, n).astype(f),   # beyond the clamp too
                turn_cmd=rng.uniform(-1.5, 1.5, n).astype(f))


@pytest.mark.parametrize("dt", [0.05, 0.1, 0.2, 0.5])
def test_step_matches_jax(dt):
    s = _seeded_states()
    js = jv.VehicleState(pos=jnp.asarray(s["pos"]), heading=jnp.asarray(s["heading"]),
                         speed=jnp.asarray(s["speed"]))
    want = jv.step(jv.VehicleState(js.pos.T, js.heading, js.speed), s["speed_cmd"],
                   s["turn_cmd"], dt)
    ts = tv.VehicleState(*(torch.as_tensor(s[k]) for k in ("pos", "heading", "speed")))
    got = tv.step(ts, torch.as_tensor(s["speed_cmd"]), torch.as_tensor(s["turn_cmd"]), dt)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos).T, atol=1e-6)
    np.testing.assert_allclose(got.heading.numpy(), np.asarray(want.heading), atol=1e-6)
    np.testing.assert_allclose(got.speed.numpy(), np.asarray(want.speed), atol=1e-6)
    assert got.pos.dtype == torch.float32


def test_init_state_and_scalar_step_match_jax():
    j = jv.init_state(1.5, -2.0, 0.3)
    t = tv.init_state(1.5, -2.0, 0.3, device="cpu")
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tb = tv.init_state(batch=(4, 3), device="cpu")
    assert tb.pos.shape == (4, 3, 2) and tb.heading.shape == (4, 3) == tb.speed.shape
    for _ in range(20):
        j = jv.step(j, 0.4, -0.6, 0.05)
        t = tv.step(t, 0.4, -0.6, 0.05)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _drive(mod):
    """Transfers of a scripted drive through a logging transport, the
    destructor's auto-stop included; and the default transport's own log."""
    sent = []
    v = mod.HostVehicle(lambda *a: sent.append(a))
    v.turn(0.75)
    v.speed(-0.18)
    v.turn(-0.3)
    v.speed(1.0)
    v.stop()
    del v
    d = mod.HostVehicle()
    d.turn(0.5)
    d.speed(0.25)
    return sent, list(d.log)


def test_host_vehicle_transfer_logs_match():
    (got, got_log), (want, want_log) = _drive(tv), _drive(jv)
    assert got == want and got_log == want_log
    assert got[:2] == [(tv.REQUEST_EXIT_SAFE_START, 0, 0), (tv.REQUEST_SET_USB_KILL, 0, 0)]
    assert got[-1] == (tv.REQUEST_SET_USB_KILL, 1, 0) and len(got) == 2 + 6 + 4 + 4


def test_emergency_stop_transfers_match():
    got, want = [], []
    tv.emergency_stop(lambda *a: got.append(a))
    jv.emergency_stop(lambda *a: want.append(a))
    # resume (2), stop (4), then the destructor's auto-stop (4)
    assert got == want and len(got) == 10


def test_stop_cli_prints_the_jax_line(capsys):
    assert j_stop.main() == 0
    want = capsys.readouterr().out
    assert t_stop.main() == 0
    assert capsys.readouterr().out == want == "stop sequence issued (10 control transfers)\n"
    res = subprocess.run([sys.executable, "-m", "slam_robot_tpu_torch.stop"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0 and res.stdout == want


def test_usb_transport_graceful_without_hardware():
    # no Pololu devices here: the factory returns None, and the raw classes
    # do not crash
    t = t_usb.pololu_transport()
    assert t is None or callable(t)
    u = t_usb.Usb()
    dev = t_usb.UsbDevice(u, 0xDEAD, (0xBEEF,))
    assert dev.handle is None
    assert dev.control_transfer(0x85, 6000, 0) == -1
