"""Application shell — the framework's equivalent of the reference's platform layer
(reference main.swift:30-166): frame loop, double-buffered pixel memory, live
resize, input plumbing, 1 Hz perf telemetry, and presentation front-ends.

The reference presents through a CAMetalLayer; headless GPU hosts present by
writing image files, streaming raw frames, or drawing 24-bit ANSI half-blocks in a
terminal. Scripted input replays make every mode deterministic and testable.

Also provides checkpoint/resume of the camera pose + frame counter (absent in the
reference — SURVEY.md section 5 — but trivial and useful for long capture runs),
in the JAX package's JSON format.

Counterpart of ``swift3drenderer_tpu.app``. Frames render on ``device``
(default the card; ``device="cpu"`` / ``--device cpu`` takes the kernels'
plain versions) through ``backend``: ``"cuda"`` (the hand-written raster
kernels, the default) or ``"xla"`` (``ops.raster_xla``), or on the host
through ``"native"`` (the C++ core of ``native/``). The JAX app's backends
are ``xla``, ``pallas`` and ``native``; its default is ``xla``. Neither app
moves to another backend by itself here: a render failure raises.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from .camera import Camera, Input, KeyboardState
from .config import DEFAULT_CONFIG, RenderConfig
from .renderer import Renderer
from .utils.databin import Scene
from .utils.ppm import unpack_rgb_words, write_ppm
from .utils.telemetry import FrameStats


class FrameLoop:
    """Owns renderer + camera + input + telemetry; one ``step()`` per frame.

    Double buffering (reference main.swift:42-44, 117-118): readback alternates
    between two host buffers so a consumer (encoder, display) can hold frame N
    while frame N+1 lands.
    """

    def __init__(self, scene: Scene, width: int = 960, height: int = 540,
                 config: RenderConfig = DEFAULT_CONFIG, backend: str = "cuda",
                 stats: Optional[FrameStats] = None,
                 bucketed: bool = False, device="cuda") -> None:
        # bucketed: capture one graph per resolution BUCKET so a live
        # drag-resize never stalls on per-size captures (reference
        # main.swift:156-165 keeps rendering at every size). Off by default —
        # exact-size frames are marginally faster for fixed-size capture runs.
        # The native core renders any size as it comes, so it has no buckets.
        self.bucketed = bucketed and backend != "native"
        self.renderer = Renderer(scene, config=config, device=device,
                                 backend=backend)
        self.camera = Camera(config)
        self.keyboard = KeyboardState()
        self.input = Input()
        self.stats = stats if stats is not None else FrameStats(printer=None)
        self.width = width
        self.height = height
        self.frame_index = 0
        self._buffers: List[Optional[np.ndarray]] = [None, None]
        self._buffer_index = 0
        self._first = True

    def resize(self, width: int, height: int) -> None:
        """Live resize (reference main.swift:156-165): new dimensions take effect
        next frame; on the card the renderer captures one graph per resolution
        (or per bucket when ``bucketed``) and replays it after."""
        if width < 1 or height < 1:
            raise ValueError(f"bad framebuffer size {width}x{height}")
        self.width = width
        self.height = height
        self._buffers = [None, None]

    def step(self, inp: Optional[Input] = None) -> np.ndarray:
        """Render one frame; returns the (H, W) uint32 pixel buffer (host)."""
        if inp is None:
            inp = self.keyboard.update_input(self.input)
        self.input = inp
        t0 = time.perf_counter()
        m = self.camera.update(inp, force_update=self._first)
        self._first = False
        # A render failure raises: the loop has no second backend to move to.
        pixels, _ = self.renderer.render(m, self.width, self.height,
                                         bucketed=self.bucketed)
        # Double buffer: copy into the alternating host buffer.
        buf = self._buffers[self._buffer_index]
        if buf is None or buf.shape != pixels.shape:
            buf = np.empty_like(pixels)
        np.copyto(buf, pixels)
        self._buffers[self._buffer_index] = buf
        self._buffer_index ^= 1
        self.stats.add_frame(time.perf_counter() - t0)
        self.frame_index += 1
        return buf

    # -- checkpoint / resume -------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        state = {"frame_index": self.frame_index,
                 "width": self.width, "height": self.height,
                 "camera": self.camera.pose_state()}
        with open(path, "w") as f:
            json.dump(state, f)

    def load_checkpoint(self, path: str) -> None:
        with open(path) as f:
            state = json.load(f)
        self.frame_index = int(state["frame_index"])
        self.resize(int(state["width"]), int(state["height"]))
        self.camera.load_pose_state(state["camera"])
        self._first = False


def scripted_inputs(script: str, frames: int) -> Iterable[Input]:
    """Parse a flight script into per-frame Inputs.

    Script syntax: semicolon-separated segments ``<frames>:<keys>`` where keys are
    any of w/a/s/d (movement), ``+`` (shift x2 speed), and ``mx<f>``/``my<f>``
    (mouse delta per frame). Example: ``60:w;30:w+mx2;30:s`` — forward 60 frames,
    fast forward-turning 30, back 30.
    """
    segments = []
    for seg in script.split(";"):
        seg = seg.strip()
        if not seg:
            continue
        count, _, keys = seg.partition(":")
        segments.append((int(count), keys))
    mouse = np.zeros(2, dtype=np.float32)
    emitted = 0
    for count, keys in segments:
        mx = my = 0.0
        if "mx" in keys:
            mx = float(keys.split("mx")[1].split("my")[0] or 1)
        if "my" in keys:
            my = float(keys.split("my")[1] or 1)
        speed = 2.0 if "+" in keys else 1.0
        for _ in range(count):
            if emitted >= frames:
                return
            mouse += (mx, my)
            yield Input(
                up=speed if "w" in keys else 0.0,
                down=speed if "s" in keys else 0.0,
                left=speed if "a" in keys else 0.0,
                right=speed if "d" in keys else 0.0,
                mouse=(float(mouse[0]), float(mouse[1])),
            )
            emitted += 1
    while emitted < frames:
        yield Input(mouse=(float(mouse[0]), float(mouse[1])))
        emitted += 1


class TerminalInput:
    """Maps raw terminal bytes to input events — the live-input analog of the
    reference's GameController callbacks (input.swift:30-59) for headless hosts.

    Keys: w/a/s/d move (hold is emulated by key-repeat decay), SHIFT+wasd = 2x,
    arrow keys = mouse look, 'c' toggles mouse capture, 'q'/ESC quits.

    The hold decay is WALL-CLOCK based (a key stays "down" HOLD_SECONDS after
    its last press), so movement speed is independent of the render rate —
    matching the reference, whose key state is true up/down callbacks under a
    fixed 60 Hz loop (input.swift:30-40, main.swift:109).
    """

    ARROW = {b"A": (0.0, -15.0), b"B": (0.0, 15.0), b"C": (15.0, 0.0),
             b"D": (-15.0, 0.0)}  # up/down/right/left
    HOLD_SECONDS = 0.2  # keep a key "down" this long after its last press

    def __init__(self, keyboard: Optional[KeyboardState] = None,
                 clock=time.monotonic) -> None:
        self.keyboard = keyboard or KeyboardState()
        self._held: dict = {}  # key -> expiry timestamp
        self._esc = b""
        self._clock = clock  # injectable for deterministic tests

    def feed(self, data: bytes) -> None:
        """Consume raw bytes read from the terminal (cbreak mode)."""
        for i in range(len(data)):
            b = data[i:i + 1]
            if self._esc:
                self._esc += b
                if self._esc in (b"\x1b[",):
                    continue
                if len(self._esc) >= 3 and self._esc[1:2] == b"[":
                    dx, dy = self.ARROW.get(self._esc[2:3], (0.0, 0.0))
                    if not self.keyboard.mouse_captured:
                        self.keyboard.toggle_capture()
                    self.keyboard.mouse_delta(dx, dy)
                else:
                    self.keyboard.quit_requested = True  # bare ESC
                self._esc = b""
                continue
            if b == b"\x1b":
                self._esc = b
                continue
            ch = b.decode("latin1")
            if ch in "qQ":
                self.keyboard.quit_requested = True
            elif ch == "c":
                self.keyboard.toggle_capture()
            elif ch.lower() in "wasd":
                expiry = self._clock() + self.HOLD_SECONDS
                self._held[ch.lower()] = expiry
                if ch.isupper():
                    self._held["shift"] = expiry

    def tick(self) -> None:
        """Advance one frame: expire held keys and sync the KeyboardState."""
        now = self._clock()
        for key in list(self._held):
            if self._held[key] <= now:
                del self._held[key]
        for key in ("w", "a", "s", "d", "shift"):
            if key in self._held:
                self.keyboard.key_event(key, True)
            else:
                self.keyboard.key_event(key, False)


def run_interactive(scene: Scene, *, width: int, height: int,
                    backend: str = "cuda",
                    config: RenderConfig = DEFAULT_CONFIG,
                    max_frames: int = 0, columns: int = 100,
                    fps: float = 60.0, gamepad: Optional[str] = None,
                    device="cuda") -> int:
    """Live terminal session: cbreak stdin -> TerminalInput -> frame loop ->
    ANSI half-block frames. Returns the number of frames rendered.

    The loop is paced to ``fps`` (default the reference's fixed 60 Hz timer,
    main.swift:39,109) with a frame-target sleep; telemetry's %-of-budget then
    measures against a true 1/60 s cadence. ``fps=0`` free-runs.
    ``gamepad`` optionally names a Linux joystick device (e.g.
    ``/dev/input/js0``) merged with the keyboard input."""
    import select
    import termios
    import tty

    loop = FrameLoop(scene, width, height, config=config, backend=backend,
                     stats=FrameStats(printer=None), device=device)
    term = TerminalInput(loop.keyboard)
    pad = None
    if gamepad is not None:
        from .joystick import JoystickInput
        pad = JoystickInput(gamepad)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    frames = 0
    target = 1.0 / fps if fps else 0.0
    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[?25l")  # hide cursor
        while not term.keyboard.quit_requested:
            t0 = time.perf_counter()
            while select.select([fd], [], [], 0)[0]:
                data = os.read(fd, 64)
                if not data:
                    break
                term.feed(data)
            term.tick()
            inp = None
            if pad is not None:
                # Reference parity: when a controller is present it IS the
                # movement/look input (input.swift:62-92 — the iOS virtual
                # controller replaces keyboard+mouse); the terminal keyboard
                # still handles quit/capture keys.
                pad.poll()
                inp = pad.update_input(loop.input)
            pixels = loop.step(inp)
            sys.stdout.write("\x1b[H" + ansi_frame(pixels, columns=columns)
                             + "\n[wasd move, SHIFT 2x, arrows look, q quit]\n")
            sys.stdout.flush()
            frames += 1
            if max_frames and frames >= max_frames:
                break
            dt = time.perf_counter() - t0
            if target > dt:
                time.sleep(target - dt)
    finally:
        if pad is not None:
            pad.close()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[?25h")
    return frames


def ansi_frame(pixels: np.ndarray, columns: int = 100) -> str:
    """Render a pixel buffer as 24-bit ANSI half-block characters (2 pixels per
    character cell vertically) for terminal presentation."""
    h, w = pixels.shape
    cols = min(columns, w)
    rows = max(1, (h * cols) // (w * 2) * 2)
    ys = (np.linspace(0, h - 1, rows)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    rgb = unpack_rgb_words(pixels[np.ix_(ys, xs)])
    out = []
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(cols):
            tr, tg, tb = rgb[r, c]
            br, bg, bb = rgb[r + 1, c]
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def run_headless(scene: Scene, *, width: int, height: int, frames: int,
                 script: str = "", backend: str = "cuda",
                 config: RenderConfig = DEFAULT_CONFIG,
                 out_dir: Optional[str] = None, out_every: int = 0,
                 checkpoint: Optional[str] = None,
                 terminal: bool = False, stats: Optional[FrameStats] = None,
                 fps: float = 0.0, device="cuda",
                 ) -> Tuple[np.ndarray, FrameStats]:
    """Scripted capture run; returns (last frame, stats).

    ``fps`` > 0 paces the loop with a frame-target sleep (the reference's 60 Hz
    timer semantics, main.swift:39,109) — useful with ``terminal`` presentation;
    the default free-runs, which is what capture runs want."""
    stats = stats or FrameStats()
    loop = FrameLoop(scene, width, height, config=config, backend=backend,
                     stats=stats, device=device)
    if checkpoint and os.path.exists(checkpoint):
        loop.load_checkpoint(checkpoint)
    pixels = None
    target = 1.0 / fps if fps else 0.0
    for i, inp in enumerate(scripted_inputs(script, frames)):
        t0 = time.perf_counter()
        pixels = loop.step(inp)
        if out_dir and out_every and i % out_every == 0:
            os.makedirs(out_dir, exist_ok=True)
            write_ppm(os.path.join(out_dir, f"frame_{loop.frame_index:05d}.ppm"),
                      unpack_rgb_words(pixels))
        if terminal:
            sys.stdout.write("\x1b[H\x1b[2J" + ansi_frame(pixels) + "\n")
            sys.stdout.flush()
        dt = time.perf_counter() - t0
        if target > dt:
            time.sleep(target - dt)
    if checkpoint:
        loop.save_checkpoint(checkpoint)
    return pixels, stats


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    from .models import SCENES
    from .utils.databin import load_scene

    p = argparse.ArgumentParser(
        prog="python -m swift3drenderer_tpu_torch.app",
        description="Headless/terminal app shell for the GPU renderer")
    p.add_argument("--scene", default="default",
                   help=f"scene name ({', '.join(SCENES)}) or a data.bin path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--script", default="60:w;60:w mx2",
                   help="flight script, e.g. '60:w;30:w+mx2;30:s'")
    p.add_argument("--backend", default="cuda",
                   choices=["cuda", "xla", "native"],
                   help="'cuda': the hand-written raster kernels (default); "
                        "'xla': the portable banded rasterizer, on the same "
                        "device; 'native': the C++ core on the host (built "
                        "at first use; --device is then not read)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render on the card (default) or on the CPU with the "
                        "kernels' plain versions")
    p.add_argument("--out", default=None, help="directory for PPM frame dumps")
    p.add_argument("--out-every", type=int, default=30)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--terminal", action="store_true",
                   help="present frames as ANSI half-blocks in the terminal")
    p.add_argument("--interactive", action="store_true",
                   help="live terminal session: wasd move, arrows look, q quit")
    p.add_argument("--serve", action="store_true",
                   help="serve a live browser view (MJPEG over HTTP) with "
                        "pointer-lock mouse capture and WASD input")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--fps", type=float, default=None,
                   help="loop pacing in Hz (default: 60 for --interactive / "
                        "--serve like the reference's 60 Hz timer, free-run "
                        "for capture; 0 = free-run)")
    p.add_argument("--gamepad", nargs="?", const="/dev/input/js0", default=None,
                   metavar="DEV",
                   help="read a Linux joystick device (default /dev/input/js0)"
                        " as the movement/look input")
    p.add_argument("--textures", default="photo",
                   choices=("photo", "procedural"),
                   help="texture source for built-in scenes: 'photo' (default)"
                        " builds ripmap atlases from real photographs for "
                        "visual parity with the reference's painting artwork "
                        "(falls back to procedural when no bundled photos "
                        "exist); 'procedural' is the seeded test default")
    args = p.parse_args(argv)

    if os.path.exists(args.scene):
        if args.scene.lower().endswith(".obj"):
            from .utils.objio import load_obj
            scene = load_obj(args.scene, offset=(0.0, 0.0, -8.0))
        else:
            scene = load_scene(args.scene)
    else:
        import inspect
        factory = SCENES[args.scene]
        textures = None
        if (args.textures == "photo"
                and "textures" in inspect.signature(factory).parameters):
            try:
                from .models.textures import photo_texture_words
                textures = photo_texture_words(2)
            except (RuntimeError, ImportError):
                pass  # no bundled photos: keep the procedural atlases
        scene = (factory(seed=args.seed, textures=textures)
                 if textures is not None else factory(seed=args.seed))
    if args.serve:
        from .viewer import run_serve

        run_serve(scene, width=args.width, height=args.height,
                  backend=args.backend, host=args.host, port=args.port,
                  device=args.device,
                  max_frames=args.frames,
                  **({"fps": args.fps} if args.fps is not None else {}),
                  **({"gamepad": args.gamepad} if args.gamepad else {}))
        return 0
    if args.interactive:
        run_interactive(scene, width=args.width, height=args.height,
                        backend=args.backend, max_frames=args.frames,
                        device=args.device,
                        fps=60.0 if args.fps is None else args.fps,
                        gamepad=args.gamepad)
        return 0
    pixels, stats = run_headless(
        scene, width=args.width, height=args.height, frames=args.frames,
        script=args.script, backend=args.backend, out_dir=args.out,
        out_every=args.out_every, checkpoint=args.checkpoint,
        terminal=args.terminal, fps=args.fps or 0.0, device=args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        write_ppm(os.path.join(args.out, "final.ppm"), unpack_rgb_words(pixels))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
