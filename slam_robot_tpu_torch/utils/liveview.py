"""Interactive live view: the reference's GUI loop served over HTTP.

Port of ``slam_robot_tpu/utils/liveview.py`` (main.cpp:609-638 draws the
debug overlay into an OpenCV window and polls keys; a headless host has no
X server, so the overlay streams as MJPEG to any browser instead). The
page, endpoints and content types are the JAX package's; frames are
encoded by the port's own ``utils/jpeg`` (the JAX package uses PIL, which
the card's host lacks), so the view serves on every host.

The SLAM loop publishes (overlay, status, points) at its own cadence;
clients pull. Publishing never blocks the robot loop: the newest frame
replaces the last one, and slow clients skip frames (each stream always
sends the latest published overlay).

    view = LiveView(port=8089).start()
    view.publish(overlay_u8_rgb, {"frame": fid, "matches": 87, ...})
    view.stop()

Endpoints:
    /        HTML page: <img> bound to /stream + status line polling /status;
             clicking a tracked point opens its patch-history strip (the
             reference's mouse-hover inspector, main.cpp:158-267)
    /stream  multipart/x-mixed-replace MJPEG of the latest overlay
    /status  latest status dict as JSON
    /points  latest per-point screen locations [[id, x, y], ...] as JSON
    /point?id=N  point N's patch-history strip as JPEG (needs an attached
             ``utils.patch_history.PatchHistory`` via ``view.patch_history``)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from slam_robot_tpu_torch.utils import jpeg

_PAGE = b"""<!doctype html>
<html><head><title>slam_robot_tpu live</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:1em }
img { border:1px solid #444; max-width:100% }
#status { margin:0.5em 0; white-space:pre }
</style></head><body>
<h3>slam_robot_tpu live view</h3>
<div id="status">waiting...</div>
<img id="view" src="/stream">
<div id="inspect" style="display:none">
  <div id="ptlabel"></div>
  <img id="strip">
</div>
<script>
setInterval(async () => {
  try {
    const r = await fetch('/status');
    const s = await r.json();
    document.getElementById('status').textContent =
      Object.entries(s).map(([k, v]) => k + '=' + v).join('  ');
  } catch (e) {}
}, 500);
// per-point patch inspector (the reference's mouse-hover inspector,
// main.cpp:158-267): click a tracked point to stream its patch history
document.getElementById('view').addEventListener('click', async (ev) => {
  const img = ev.target;
  const sx = img.naturalWidth / img.clientWidth;
  const sy = img.naturalHeight / img.clientHeight;
  const x = ev.offsetX * sx, y = ev.offsetY * sy;
  try {
    const pts = await (await fetch('/points')).json();
    let best = null, bd = 25 * 25;
    for (const [id, px, py] of pts) {
      const d = (px - x) * (px - x) + (py - y) * (py - y);
      if (d < bd) { bd = d; best = id; }
    }
    if (best === null) return;
    document.getElementById('inspect').style.display = 'block';
    document.getElementById('ptlabel').textContent =
      'point ' + best + ' (newest patch first)';
    document.getElementById('strip').src =
      '/point?id=' + best + '&t=' + Date.now();
  } catch (e) {}
});
</script>
</body></html>
"""


class LiveView:
    """Thread-backed MJPEG/status server over the latest published frame.
    ``port=0`` binds a free port, which :meth:`start` writes to ``port``."""

    def __init__(self, port: int = 8089, host: str = "0.0.0.0", quality: int = 85):
        self.port = port
        self.host = host
        self.quality = quality
        # attach a utils.patch_history.PatchHistory to enable the per-point
        # click inspector (/points + /point?id=N)
        self.patch_history = None
        self._cond = threading.Condition()
        self._jpeg: bytes | None = None
        self._status: dict = {}
        self._points: list = []
        self._seq = 0
        self._stopped = False
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ---- producer side (the SLAM loop) ----

    def publish(self, overlay, status: dict | None = None, points=None) -> None:
        """Publish a new frame: ``overlay`` is an [H, W, 3] uint8 RGB image.
        Encoding happens here, once per publish, so N stream clients cost no
        extra encodes. ``points`` optionally carries [[point_id, x, y], ...]
        screen locations of the currently matched points: the click targets
        the inspector page maps onto /point?id=N."""
        data = jpeg.encode(np.asarray(overlay), self.quality)
        with self._cond:
            self._jpeg = data
            if status is not None:
                self._status = dict(status)
            if points is not None:
                self._points = [[int(i), float(x), float(y)] for i, x, y in points]
            self._seq += 1
            self._cond.notify_all()

    def _strip_jpeg(self, point_id: int) -> bytes | None:
        """Point ``point_id``'s patch-history strip as grey JPEG bytes
        (newest patch first, main.cpp:199-247)."""
        if self.patch_history is None:
            return None
        strip = self.patch_history.strip(point_id)
        if strip is None:
            return None
        return jpeg.encode(np.clip(strip * 255.0, 0.0, 255.0).astype(np.uint8), self.quality)

    # ---- server lifecycle ----

    def start(self) -> "LiveView":
        view = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: the SLAM loop owns stdout
                pass

            def _send(self, ctype: str, body: bytes) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send("text/html", _PAGE)
                elif self.path == "/status":
                    with view._cond:
                        body = json.dumps(view._status).encode()
                    self._send("application/json", body)
                elif self.path == "/points":
                    with view._cond:
                        body = json.dumps(view._points).encode()
                    self._send("application/json", body)
                elif self.path.startswith("/point?"):
                    q = parse_qs(urlparse(self.path).query)
                    try:
                        pid = int(q.get("id", ["-1"])[0])
                    except ValueError:
                        pid = -1
                    data = view._strip_jpeg(pid)
                    if data is None:
                        self.send_error(404, "no patch history for this point")
                        return
                    self._send("image/jpeg", data)
                elif self.path == "/stream":
                    self._stream()
                else:
                    self.send_error(404)

            def _stream(self):
                self.send_response(200)
                self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                last = -1
                try:
                    while True:
                        with view._cond:
                            view._cond.wait_for(
                                lambda: view._seq != last or view._stopped, timeout=2.0)
                            if view._stopped:
                                return
                            data, last = view._jpeg, view._seq
                        if data is None:
                            continue
                        self.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n")
                        self.wfile.write(f"Content-Length: {len(data)}\r\n\r\n".encode())
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return  # the client went away

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port=0
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name="liveview-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving: open streams end, the server thread exits."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
            self._thread.join(timeout=5.0)
