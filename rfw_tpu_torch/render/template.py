"""Template engine scaffold with every ABI method stubbed (port of
``rfw_tpu.render.template``).

The analog of the reference's TemplateRenderer: copy this file, rename
the class, register it with ``register_engine`` and fill in the methods
to bring a new engine into the cross-engine tests. Not registered.
"""

from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from .context import EngineContext, RenderStatus, resolve_device


class TemplateEngine(EngineContext):
    """Minimal skeleton: accepts the scene, renders black frames."""

    def __init__(self, config: RenderConfig | None = None, *,
                 device="cuda"):
        super().__init__(config)
        self.device = resolve_device(device)
        self._size = (0, 0)
        self._pending = False

    def set_mesh(self, slot, triangles):
        pass

    def set_instance(self, instance_id, mesh_slot, transform):
        pass

    def remove_instance(self, instance_id):
        pass

    def set_materials(self, device_materials):
        pass

    def set_textures(self, atlas):
        pass

    def set_lights(self, lights, overrides=None):
        pass

    def set_sky(self, pixels):
        pass

    def update(self):
        pass

    def resize(self, width, height):
        self._size = (width, height)

    def render_frame_async(self, view,
                           status: RenderStatus = RenderStatus.RESET,
                           samples: int = 1) -> None:
        self._pending = True

    def finish_frame(self) -> np.ndarray:
        if not self._pending:
            raise RuntimeError("finish_frame without a frame in flight")
        self._pending = False
        w, h = self._size
        return np.zeros((h, w, 3), np.float32)

    def get_probe_results(self):
        return (-1, -1, -1.0)
