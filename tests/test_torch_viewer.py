"""The port's live HTTP viewer (``swift3drenderer_tpu_torch.viewer``) around
a bucketed ``FrameLoop`` on ``device="cpu"``: the page, ``/frame``,
``/stream``, the input and resize events, and ``encode_jpeg`` against the
JAX module's bytes."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from swift3drenderer_tpu_torch.app import FrameLoop
from swift3drenderer_tpu_torch.models import tetrahedron_scene
from swift3drenderer_tpu_torch.viewer import ViewerServer, encode_jpeg

torch.set_num_threads(1)


@pytest.fixture
def server():
    loop = FrameLoop(tetrahedron_scene(seed=0), width=96, height=64,
                     device="cpu", bucketed=True)
    srv = ViewerServer(loop, port=0, fps=0.0)
    t = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.stop()


def _get(srv, path, timeout=10):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}{path}", timeout=timeout)


def _post(srv, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/input",
                                 data=json.dumps(obj).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=10)


def test_page_and_frame(server):
    from swift3drenderer_tpu.viewer import _PAGE as JAX_PAGE

    page = _get(server, "/").read()
    assert b"pointerLock" in page and page == JAX_PAGE.encode()
    server.render_one()
    jpeg = _get(server, "/frame").read()
    assert jpeg[:2] == b"\xff\xd8"
    with pytest.raises(urllib.error.HTTPError):
        _get(server, "/nothing")


def test_stream_delivers_frames(server):
    server.render_one()
    resp = _get(server, "/stream")
    assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
    threading.Timer(0.2, server.render_one).start()
    assert b"--frame" in resp.fp.read(40)


def test_input_events_drive_keyboard_and_resize(server):
    assert _post(server, {"key": ["w", True], "capture": True}).status == 204
    _post(server, {"mouse": [3.0, 1.0]})
    kb = server.loop.keyboard
    assert kb.mouse_captured
    inp = kb.update_input(server.loop.input)
    assert inp.up == 1.0 and inp.mouse != (0.0, 0.0)
    f0 = server.render_one().copy()
    f1 = server.render_one()
    assert (f0 != f1).any()
    # A resize sweep: the loop follows the latest request, one graph key
    # per bucket (eager on the CPU), every frame at the requested size.
    for w, h in ((100, 60), (112, 80), (120, 90)):
        _post(server, {"resize": [w, h]})
    assert server.step().shape == (90, 120)
    assert (server.loop.width, server.loop.height) == (120, 90)
    _post(server, {"key": ["w", False], "capture": False})
    assert not kb.mouse_captured
    assert kb.update_input(server.loop.input).up == 0.0
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/input",
                                 data=b"not json", method="POST")
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(req, timeout=10)


def test_encode_jpeg_matches_jax():
    pytest.importorskip("PIL")
    from PIL import Image
    from swift3drenderer_tpu.viewer import encode_jpeg as jax_encode

    rng = np.random.default_rng(3)
    pixels = rng.integers(0, 1 << 24, size=(24, 40)).astype(np.uint32)
    for quality in (85, 95):
        assert encode_jpeg(pixels, quality) == jax_encode(pixels, quality)
    red = np.full((8, 8), 0x00FF0000, np.uint32)
    arr = np.asarray(Image.open(io.BytesIO(encode_jpeg(red, quality=95))))
    assert arr.shape == (8, 8, 3)
    assert arr[..., 0].mean() > 200 and arr[..., 1].mean() < 60
