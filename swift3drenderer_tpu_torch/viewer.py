"""Live graphical presentation over HTTP — the headless-host analog of the
reference's windowed present path (reference main.swift:124-140: pixel buffer ->
CIImage -> CAMetalLayer drawable).

A GPU host has no display, so the "window" is the user's browser:

* ``GET /``        a page with the live view, pointer-lock mouse capture and
                   WASD key handling (the reference's click-to-capture cursor
                   semantics, input.swift:47-59);
* ``GET /stream``  an MJPEG (multipart/x-mixed-replace) stream fed from the
                   frame loop's double buffer;
* ``GET /frame``   a single JPEG of the latest frame;
* ``POST /input``  input events (keys/mouse/resize) folded into KeyboardState.

The render loop stays on the main thread (it owns the renderer and its
captured graphs); HTTP handlers run on daemon threads and only touch the
latest encoded JPEG under a condition variable, so a slow client can never
stall rendering (the same data-race-free handoff the reference gets from
double buffering, main.swift:42-44).

Counterpart of ``swift3drenderer_tpu.viewer`` around the port's
``FrameLoop(bucketed=True)``; the page's HTML is the JAX module's. PIL is
imported only by ``encode_jpeg``.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from .app import FrameLoop
from .utils.ppm import unpack_rgb_words

_PAGE = """<!DOCTYPE html>
<html><head><title>swift3drenderer_tpu</title><style>
  body { margin:0; background:#1e1e1e; color:#ddd; font:13px monospace;
         display:flex; flex-direction:column; align-items:center }
  img  { image-rendering:pixelated; margin-top:8px; outline:none }
  #bar { padding:6px }
</style></head><body>
<div id="bar">click view to capture mouse &mdash; wasd move, shift 2x, esc release</div>
<img id="view" src="/stream" draggable="false">
<script>
const view = document.getElementById('view');
const keys = {};
function post(o) {
  fetch('/input', {method:'POST', body:JSON.stringify(o)});
}
view.addEventListener('click', () => view.requestPointerLock());
document.addEventListener('pointerlockchange', () => {
  post({capture: document.pointerLockElement === view});
});
document.addEventListener('mousemove', (e) => {
  if (document.pointerLockElement === view && (e.movementX || e.movementY))
    post({mouse: [e.movementX, e.movementY]});
});
function keymap(e) {
  const k = e.key.toLowerCase();
  if (['w','a','s','d','shift'].includes(k)) return k;
  return null;
}
document.addEventListener('keydown', (e) => {
  const k = keymap(e); if (!k || keys[k]) return;
  keys[k] = true; post({key: [k, true]});
});
document.addEventListener('keyup', (e) => {
  const k = keymap(e); if (!k) return;
  delete keys[k]; post({key: [k, false]});
});
// Drag-resize follows the window (debounced); the renderer compiles per
// resolution bucket, so sweeping sizes never stalls on recompiles.
let rt;
window.addEventListener('resize', () => {
  clearTimeout(rt);
  rt = setTimeout(() => post({resize: [
    Math.max(128, window.innerWidth - 16),
    Math.max(64, window.innerHeight - 48)]}), 200);
});
</script></body></html>"""


def encode_jpeg(pixels: np.ndarray, quality: int = 85) -> bytes:
    """Packed 0x00RRGGBB (H, W) uint32 -> JPEG bytes."""
    from PIL import Image

    rgb = unpack_rgb_words(pixels)
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class FrameHub:
    """Latest-frame handoff between the render thread and HTTP streamers."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._jpeg: Optional[bytes] = None
        self._seq = 0

    def publish(self, jpeg: bytes) -> None:
        with self._cond:
            self._jpeg = jpeg
            self._seq += 1
            self._cond.notify_all()

    def wait(self, last_seq: int, timeout: float = 5.0) -> Tuple[Optional[bytes], int]:
        with self._cond:
            self._cond.wait_for(lambda: self._seq != last_seq, timeout=timeout)
            return self._jpeg, self._seq


class ViewerServer:
    """HTTP front-end around a FrameLoop. ``serve_forever`` renders frames on
    the calling thread at ``fps`` (the reference's 60 Hz timer, main.swift:109)
    and publishes them to any number of connected streams."""

    def __init__(self, loop: FrameLoop, host: str = "127.0.0.1",
                 port: int = 8000, fps: float = 60.0,
                 quality: int = 85, gamepad: Optional[str] = None) -> None:
        self.loop = loop
        self.hub = FrameHub()
        self.fps = fps
        self.quality = quality
        self._stop = threading.Event()
        self._lock = threading.Lock()  # guards KeyboardState mutation
        self.pad = None
        if gamepad is not None:
            from .joystick import JoystickInput
            self.pad = JoystickInput(gamepad)

        hub, stop, lock, kb = self.hub, self._stop, self._lock, loop.keyboard
        resize_req: list = []

        class Handler(BaseHTTPRequestHandler):
            daemon_threads = True

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame":
                    jpeg, _ = hub.wait(-1)
                    if jpeg is None:
                        self.send_error(503, "no frame yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpeg)))
                    self.end_headers()
                    self.wfile.write(jpeg)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seq = -1
                    try:
                        while not stop.is_set():
                            jpeg, seq = hub.wait(seq)
                            if jpeg is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jpeg)}\r\n\r\n".encode())
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # client went away
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/input":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self.send_error(400)
                    return
                with lock:
                    if "key" in ev:
                        key, down = ev["key"]
                        kb.key_event(str(key), bool(down))
                    if "mouse" in ev:
                        dx, dy = ev["mouse"]
                        kb.mouse_delta(float(dx), float(dy))
                    if "capture" in ev:
                        if bool(ev["capture"]) != kb.mouse_captured:
                            kb.toggle_capture()
                    if "resize" in ev:
                        w, h = ev["resize"]
                        resize_req.append((int(w), int(h)))
                self.send_response(204)
                self.end_headers()

        self._resize_req = resize_req
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def render_one(self) -> np.ndarray:
        """One frame: poll input state, render, publish."""
        pixels = self.step()
        self.hub.publish(encode_jpeg(pixels, self.quality))
        return pixels

    def step(self) -> np.ndarray:
        """One frame without the JPEG: apply the latest resize request and
        the input state, render; returns the pixels."""
        with self._lock:
            if self._resize_req:
                w, h = self._resize_req[-1]
                del self._resize_req[:]
                if (w, h) != (self.loop.width, self.loop.height):
                    self.loop.resize(w, h)
            if self.pad is not None:
                # A physical controller IS the movement/look input (reference
                # input.swift:62-92); browser keys still drive capture/quit.
                self.pad.poll()
                inp = self.pad.update_input(self.loop.input)
            else:
                inp = self.loop.keyboard.update_input(self.loop.input)
        return self.loop.step(inp)

    def serve_forever(self, max_frames: int = 0) -> int:
        """Render+serve until stop() / quit; returns frames rendered."""
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        frames = 0
        target = 1.0 / self.fps if self.fps else 0.0
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                self.render_one()
                frames += 1
                if max_frames and frames >= max_frames:
                    break
                if self.loop.keyboard.quit_requested:
                    break
                dt = time.perf_counter() - t0
                if target > dt:
                    time.sleep(target - dt)
        finally:
            self.stop()
        return frames

    def stop(self) -> None:
        self._stop.set()
        if self.pad is not None:
            self.pad.close()
        self.hub.publish(self.hub._jpeg or b"")  # wake streamers
        self.httpd.shutdown()


def run_serve(scene, *, width: int, height: int, backend: str = "cuda",
              config=None, host: str = "127.0.0.1", port: int = 8000,
              fps: float = 60.0, max_frames: int = 0,
              gamepad: Optional[str] = None, device="cuda") -> int:
    """Entry point for ``python -m swift3drenderer_tpu_torch.app --serve``.
    ``backend`` goes to the frame loop as it is: ``"cuda"``, ``"xla"`` or
    the host's ``"native"`` (which renders every size as it comes, without
    buckets)."""
    from .config import DEFAULT_CONFIG
    from .utils.telemetry import FrameStats

    # Bucketed: browser-driven live resizes must never stall on per-size
    # graph captures.
    loop = FrameLoop(scene, width, height,
                     config=config or DEFAULT_CONFIG, backend=backend,
                     stats=FrameStats(), bucketed=True, device=device)
    server = ViewerServer(loop, host=host, port=port, fps=fps, gamepad=gamepad)
    print(f"serving live view on http://{host}:{server.port}/", flush=True)
    return server.serve_forever(max_frames=max_frames)
