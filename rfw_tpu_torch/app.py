"""Application harness, the headless frame loop (port of ``rfw_tpu.app``).

Subclass, implement ``init``/``update``, call ``App.run``. The reference
drives a GLFW window; a render service has no window, so each frame is
rendered, tonemapped and handed to ``post_render`` (write PNGs, stream,
encode video). The camera persists to camera.bin across runs.

Unlike rfw_tpu's, a raising ``update`` surfaces as itself: the in-flight
frame is retired in a ``try`` of its own, whose failure is logged, and
the engine is left with no frame in flight. rfw_tpu retires it in a
``finally`` block, where a second exception hides the first.
"""

from __future__ import annotations

import os
import traceback

import numpy as np

from .camera import Camera
from .config import RenderConfig
from .system import RenderSystem
from .utils import Timer, image, logger


class App:
    """Subclass and override init/update/post_render."""

    def __init__(self, width: int = 512, height: int = 512,
                 engine: str = "megakernel",
                 config: RenderConfig | None = None,
                 camera_file: str = "camera.bin",
                 output_dir: str = "frames",
                 fxaa: bool = True, *, device="cuda"):
        self.rs = RenderSystem(engine, config, device=device)
        self.camera_file = camera_file
        self.output_dir = output_dir
        # the reference app runs FXAA over the tonemapped target
        self.fxaa = fxaa
        self.rs.camera = Camera.deserialize(camera_file)
        self.rs.camera.resize(width, height)
        self.frame_index = 0

    # -- user hooks ----------------------------------------------------------

    def init(self, rs: RenderSystem) -> None:
        """Build the scene: add_object / add_quad / lights / materials."""

    def update(self, rs: RenderSystem, dt: float) -> bool:
        """Advance state (camera moves, set_animations_to). Return False to
        stop the loop."""
        return False

    def post_render(self, frame: np.ndarray, frame_index: int) -> None:
        """Receive the tonemapped frame (H, W, 3) linear [0,1]."""
        os.makedirs(self.output_dir, exist_ok=True)
        image.save_png(
            os.path.join(self.output_dir, f"frame_{frame_index:05d}.png"),
            frame)

    # -- loop ----------------------------------------------------------------

    def run(self, frames: int = 1, samples_per_frame: int = 1,
            pipeline: bool = True) -> None:
        """The frame loop. With ``pipeline=True`` (default) each frame is
        dispatched and ``update`` (animation, skinning, camera moves) runs
        while the device traces it. Frames are the same either way: the
        scene and camera of frame k are read at dispatch, so ``update``'s
        changes reach frame k + 1, as in the sequential loop.

        Hook order: with ``pipeline=True`` the ``update`` for frame k + 1
        runs before frame k's ``post_render`` and before ``frame_index``
        increments. Subclasses whose ``update`` reads ``self.frame_index``
        or state written by ``post_render`` should pass
        ``pipeline=False``."""
        self.init(self.rs)
        timer = Timer()
        for _ in range(frames):
            dt = timer.elapsed()
            timer.reset()
            if pipeline:
                cam = self.rs.camera
                brightness, contrast = cam.brightness, cam.contrast
                self.rs.render_frame_async(samples=samples_per_frame)
                try:
                    running = self.update(self.rs, dt)  # overlaps render
                except BaseException:
                    # retire the in-flight frame (a later dispatch would
                    # trip the in-flight guard), then raise update's
                    # exception, not the retirement's
                    try:
                        self.rs.finish_frame()
                    except Exception:
                        logger.warning("retiring the frame after a failed "
                                       "update also failed:\n%s",
                                       traceback.format_exc())
                    raise
                frame = self.rs.tonemap_frame(self.rs.finish_frame(),
                                              brightness, contrast,
                                              fxaa=self.fxaa)
            else:
                frame = self.rs.render_tonemapped(
                    samples=samples_per_frame, fxaa=self.fxaa)
            self.post_render(frame, self.frame_index)
            self.frame_index += 1
            stats = self.rs.get_render_stats()
            logger.debug(
                "frame %d: %.1f ms render, %.2f Mrays/s", self.frame_index,
                stats.render_time * 1e3, stats.mrays_per_s())
            if not (running if pipeline else self.update(self.rs, dt)):
                break
        try:
            self.rs.camera.serialize(self.camera_file)
        except OSError as e:
            logger.warning("could not persist camera: %s", e)
