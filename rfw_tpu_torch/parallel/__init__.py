"""Tiles over several devices (port of ``rfw_tpu.parallel``): a row
block of the pixels a tile, the scene copied to each device, and one
host process driving every tile. ``RenderConfig.n_devices > 1`` routes
the engines through ``tiles``."""

from .mesh import make_tile_mesh, replicate, row_block
from .tiles import make_tiled_renderer, render_tiled

__all__ = ["make_tile_mesh", "replicate", "row_block",
           "make_tiled_renderer", "render_tiled"]
