"""Engine ABI (port of ``rfw_tpu.render.context``): the upload + render
surface every engine implements, the RESET/CONVERGE protocol, RenderStats,
the enumerable runtime settings, and the engine registry."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..config import RenderConfig


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another. Raises when the card is asked for and absent, so
    nothing falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: rfw_tpu_torch runs on the card by default "
            "(torch.cuda.is_available() is false); pass device='cpu' to "
            "run on the CPU")
    return dev


class RenderStatus(enum.Enum):
    RESET = 0      # camera/scene changed: clear the accumulator
    CONVERGE = 1   # keep accumulating


@dataclasses.dataclass
class RenderStats:
    """Per-frame stage stats."""

    primary_count: int = 0
    secondary_count: int = 0
    deep_count: int = 0
    shadow_count: int = 0
    primary_time: float = 0.0
    secondary_time: float = 0.0
    deep_time: float = 0.0
    render_time: float = 0.0

    def clear(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, type(getattr(self, f.name))())

    def mrays_per_s(self) -> float:
        rays = (self.primary_count + self.secondary_count + self.deep_count
                + self.shadow_count)
        return rays / max(self.render_time, 1e-9) / 1e6


@dataclasses.dataclass
class RenderSetting:
    """One enumerable runtime setting."""

    name: str
    value: str
    options: list[str]


class EngineContext:
    """Abstract engine: scene uploads, frames, probe, settings, stats."""

    def __init__(self, config: RenderConfig | None = None):
        self.config = config or RenderConfig()
        self.stats = RenderStats()
        self._probe_xy = (0, 0)

    def set_mesh(self, slot: int, triangles) -> None:
        raise NotImplementedError

    def set_instance(self, instance_id: int, mesh_slot: int,
                     transform: np.ndarray) -> None:
        raise NotImplementedError

    def remove_instance(self, instance_id: int) -> None:
        raise NotImplementedError

    def set_materials(self, device_materials: dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def set_textures(self, atlas: dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def set_lights(self, lights: dict[str, np.ndarray],
                   overrides=None) -> None:
        raise NotImplementedError

    def set_sky(self, pixels: np.ndarray) -> None:
        raise NotImplementedError

    def update(self) -> None:
        """Commit pending scene changes."""
        raise NotImplementedError

    def render_frame_async(self, view, status: RenderStatus,
                           samples: int = 1) -> None:
        """Dispatch a frame; ``finish_frame()`` collects it."""
        raise NotImplementedError

    def finish_frame(self) -> np.ndarray:
        raise NotImplementedError

    def render_frame(self, view, status: RenderStatus = RenderStatus.RESET,
                     samples: int = 1) -> np.ndarray:
        """Trace ``samples`` samples per pixel; returns the resolved HDR
        framebuffer (H, W, 3). Progressive until RESET."""
        self.render_frame_async(view, status, samples)
        return self.finish_frame()

    def set_probe_index(self, pixel_xy: tuple[int, int]) -> None:
        self._probe_xy = tuple(pixel_xy)

    def get_probe_results(self) -> tuple[int, int, float]:
        """(instance_id, prim_id, distance) under the probe pixel."""
        raise NotImplementedError

    def get_available_settings(self) -> list[RenderSetting]:
        return []

    def set_setting(self, name: str, value: str) -> None:
        known = {s.name for s in self.get_available_settings()}
        if name not in known:
            raise KeyError(f"unknown setting {name!r}; available: {known}")

    def get_stats(self) -> RenderStats:
        return self.stats


_ENGINES: dict[str, type] = {}


def register_engine(name: str):
    def deco(cls):
        _ENGINES[name] = cls
        cls.engine_name = name
        return cls
    return deco


def available_engines() -> list[str]:
    _ensure_imported()
    return sorted(_ENGINES)


def create_engine(name: str, config: RenderConfig | None = None, *,
                  device="cuda") -> EngineContext:
    """Instantiate an engine by name on ``device`` (the card by default)."""
    _ensure_imported()
    if name not in _ENGINES:
        raise KeyError(
            f"unknown engine {name!r}; available: {available_engines()}")
    return _ENGINES[name](config=config, device=resolve_device(device))


def _ensure_imported() -> None:
    from . import engines as _e  # noqa: F401  (registers via decorators)
    from . import raster as _r  # noqa: F401
