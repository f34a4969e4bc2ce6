"""Interactive live viewer demo: drive the camera around a scene in the
browser (the port of ``examples/viewer.py``).

    python -m rfw_tpu_torch.examples.viewer --size 256 --port 8000 \\
        [--asset model.gltf] [--duration SECONDS] [--device cpu]
    # open http://127.0.0.1:8000: WASD/QE and the arrows, click to probe
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.scene import Skybox
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.viewer import LiveViewer


def build(rs: RenderSystem, asset: str | None) -> str:
    """The model at ``asset`` framed by the camera, or (no asset, or no
    file there) a floor and a red quad; a lamp quad and the test sky.
    Returns which of the two it built."""
    if asset and os.path.exists(asset):
        ref = rs.add_object(asset)
        rs.add_instance(ref)
        v = np.concatenate([m.triangles().vertices.reshape(-1, 3)
                            for m in ref.object.meshes])
        lo, hi = v.min(0), v.max(0)
        c = 0.5 * (lo + hi)
        rs.camera.look_at(c + (hi - lo) * np.array([0.8, 0.5, 1.2]), c)
        scene = asset
    else:
        floor = rs.add_material([0.6, 0.6, 0.65])
        red = rs.add_material([0.7, 0.15, 0.1])
        rs.add_instance(rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor))
        rs.add_instance(rs.add_quad([0, 0, -1], [0, 1, 2], 2, 2, red))
        rs.camera.look_at([0, 2.5, -5.0], [0, 1.0, 0.0])
        scene = "the quad scene"
    lamp = rs.add_material([30.0, 30.0, 30.0])
    rs.add_instance(rs.add_quad([0, -1, 0], [0, 6.0, 0], 2, 2, lamp))
    rs.set_skybox(Skybox.test_sky(128, 64))
    return scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--engine", default="wavefront")
    ap.add_argument("--asset", default=None,
                    help="model path (gltf/obj/...); default quad scene")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cpu for the CPU)")
    args = ap.parse_args(argv)

    rs = RenderSystem(args.engine, RenderConfig(), device=args.device)
    scene = build(rs, args.asset)
    viewer = LiveViewer(rs, args.size, args.size, port=args.port)
    print(f"live viewer on http://127.0.0.1:{viewer.port}: {scene}, "
          f"{args.engine} on {rs.device}", flush=True)
    viewer.run(duration=args.duration)
    return 0


if __name__ == "__main__":
    sys.exit(main())
