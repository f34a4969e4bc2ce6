from .builder import BVH, build_bvh, triangle_bounds
from .tlas import BLAS, TLAS, build_blas, build_tlas, trace_tlas
from .wide import (SUPER_G, Treelets, WideBVH, collapse_wide,
                   extract_treelets, spatial_treelets, subdivide_cells)

__all__ = ["BVH", "build_bvh", "triangle_bounds", "SUPER_G", "Treelets",
           "WideBVH", "collapse_wide", "extract_treelets",
           "spatial_treelets", "subdivide_cells", "BLAS", "TLAS", "build_blas",
           "build_tlas", "trace_tlas"]
