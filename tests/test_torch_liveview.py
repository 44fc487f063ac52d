"""The port's live view (``utils/liveview``, ``run_replay --serve``) and its
JPEG encoder (``utils/jpeg``), on the CPU.

- ``LiveView`` serves what the JAX package's does: the counterparts of
  tests/test_utils.py's two live-view tests, over real HTTP on localhost.
- ``jpeg.encode`` writes PIL's headers and tables (quality 85: the scaled
  standard quantization tables, the standard Huffman tables, 4:2:0 for
  RGB, one component for grey); PIL decodes its output to the input's
  shape, and its PSNR against the input is within 1.5 dB of PIL's own
  encode of the same image.
- ``run_replay --synthetic 3 --serve PORT --device cpu``, in the per-frame
  loop and in --live, with PIL out of reach and a client thread reading
  /status and one /stream part while the run goes on; the run's summary
  equals the same run's without --serve in n_points and n_obs.
"""

import contextlib
import http.client
import io
import json
import socket
import sys
import threading
import time

import numpy as np
import pytest

from slam_robot_tpu_torch import run_replay
from slam_robot_tpu_torch.utils import jpeg
from slam_robot_tpu_torch.utils.liveview import LiveView
from slam_robot_tpu_torch.utils.patch_history import PatchHistory

PIL = pytest.importorskip("PIL.Image")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_part(r) -> bytes:
    """One part of a multipart/x-mixed-replace response: its JPEG bytes."""
    assert b"--frame" in r.fp.readline()
    assert b"image/jpeg" in r.fp.readline()
    n = int(r.fp.readline().split(b":")[1])
    r.fp.readline()
    return r.fp.read(n)


def _segments(data: bytes) -> dict:
    """Marker -> list of payloads, up to the start of scan."""
    out, i = {}, 2
    while True:
        marker = data[i + 1]
        n = int.from_bytes(data[i + 2:i + 4], "big")
        out.setdefault(marker, []).append(data[i + 4:i + 2 + n])
        if marker == 0xDA:
            return out
        i += 2 + n


def test_liveview_serves_stream_and_status():
    """tests/test_utils.py:225 on the port's LiveView."""
    view = LiveView(port=0, host="127.0.0.1").start()
    try:
        overlay = np.zeros((24, 32, 3), np.uint8)
        overlay[:, :, 1] = 200
        view.publish(overlay, {"frame": 7, "matches": 42})
        c = http.client.HTTPConnection("127.0.0.1", view.port, timeout=5)
        c.request("GET", "/")
        assert b"slam_robot_tpu" in c.getresponse().read()
        c.request("GET", "/status")
        r = c.getresponse()
        assert r.getheader("Content-Type") == "application/json"
        assert json.loads(r.read()) == {"frame": 7, "matches": 42}
        c.request("GET", "/stream")
        r = c.getresponse()
        assert r.getheader("Content-Type").startswith("multipart/x-mixed-replace")
        data = _read_part(r)
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        assert np.asarray(PIL.open(io.BytesIO(data))).shape == (24, 32, 3)
        c.close()
    finally:
        view.stop()


def test_liveview_point_inspector_endpoints():
    """tests/test_utils.py:288 on the port's LiveView."""
    ph = PatchHistory(size=5)
    img = np.arange(40 * 30, dtype=np.float32).reshape(30, 40) / 1200.0
    ph.update(img, np.array([3, 7, -1]), np.array([[10.0, 12.0], [20.0, 8.0], [5.0, 5.0]]),
              np.array([True, True, True]))
    view = LiveView(port=0, host="127.0.0.1").start()
    view.patch_history = ph
    try:
        view.publish(np.zeros((24, 32, 3), np.uint8), {"frame": 1},
                     points=[(3, 10.0, 12.0), (7, 20.0, 8.0)])
        c = http.client.HTTPConnection("127.0.0.1", view.port, timeout=5)
        c.request("GET", "/points")
        assert json.loads(c.getresponse().read()) == [[3, 10.0, 12.0], [7, 20.0, 8.0]]
        c.request("GET", "/point?id=3")
        r = c.getresponse()
        body = r.read()
        assert r.status == 200 and r.getheader("Content-Type") == "image/jpeg"
        strip = np.asarray(PIL.open(io.BytesIO(body)))
        assert strip.shape == ph.strip(3).shape  # one grey component
        c.request("GET", "/point?id=999")
        r = c.getresponse()
        r.read()
        assert r.status == 404
        c.close()
    finally:
        view.stop()


def _overlay() -> np.ndarray:
    """A 480x640 debug overlay: a smooth grey scene with coloured marks."""
    yy, xx = np.mgrid[0:480, 0:640]
    grey = (128 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)).astype(np.uint8)
    img = np.repeat(grey[..., None], 3, -1)
    rng = np.random.default_rng(5)
    for x, y in rng.integers([10, 10], [630, 470], size=(200, 2)):
        for d in range(-3, 4):
            img[y + d, x + d] = (255, 0, 0)
            img[y - d, x + d] = (0, 255, 0)
    return img


def _psnr(a, b) -> float:
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / err)


@pytest.mark.parametrize("shape", [(480, 640, 3), (37, 53, 3), (101, 77)])
def test_jpeg_decodes_and_matches_pil(shape):
    img = _overlay()[:shape[0], :shape[1]]
    if len(shape) == 2:
        img = np.ascontiguousarray(img[..., 0])
    if shape[0] < 100 and len(shape) == 3:  # noise, the hardest case
        img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    data = jpeg.encode(img, 85)
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="JPEG", quality=85)
    ref = buf.getvalue()
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    mine, pil = _segments(data), _segments(ref)
    for marker in (0xDB, 0xC0, 0xDA):  # quantization tables, frame, scan header
        assert b"".join(mine[marker]) == b"".join(pil[marker]), hex(marker)
    # the same Huffman tables (PIL writes one segment a table)
    assert b"".join(mine[0xC4]) == b"".join(pil[0xC4])
    dec = np.asarray(PIL.open(io.BytesIO(data)))
    assert dec.shape == img.shape
    assert abs(_psnr(dec, img) - _psnr(np.asarray(PIL.open(io.BytesIO(ref))), img)) <= 1.5


def _serve_client(port: int, out: dict, done: threading.Event) -> None:
    """Wait for the server, read one /stream part, then /status."""
    deadline = time.time() + 120
    while not done.is_set() and time.time() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("GET", "/stream")
            r = c.getresponse()
            break
        except OSError:
            time.sleep(0.02)
    else:
        return
    out["part"] = _read_part(r)
    c.close()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("GET", "/status")
    out["status"] = json.loads(c.getresponse().read())
    c.close()


@pytest.mark.parametrize("live", [False, True])
def test_replay_serves_while_it_runs(live, monkeypatch):
    """The served run imports no PIL (as on a host without it)."""
    base = ["--synthetic", "3", "--device", "cpu", "--width", "160", "--height", "120",
            "--quiet", "--view-every", "1"] + (["--live"] if live else [])

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert run_replay.main(argv) == 0
        return json.loads(out.getvalue().strip().splitlines()[-1]), out.getvalue()

    port = _free_port()
    got, done = {}, threading.Event()
    client = threading.Thread(target=_serve_client, args=(port, got, done), daemon=True)
    client.start()
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)  # an import of PIL raises
        summary, text = run(base + ["--serve", str(port)])
    done.set()
    client.join(timeout=60)
    assert not client.is_alive()
    assert f"live view: http://0.0.0.0:{port}/" in text
    data = got["part"]
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert np.asarray(PIL.open(io.BytesIO(data))).shape == (120, 160, 3)
    assert isinstance(got["status"], dict)
    if not live:  # the live loop's status waits for its first ring read
        assert {"frame", "matches", "points"} <= set(got["status"])
    plain, _ = run(base)
    assert (summary["n_points"], summary["n_obs"]) == (plain["n_points"], plain["n_obs"])
