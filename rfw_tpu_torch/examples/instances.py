"""Instance dynamics demo: a grid of shared-mesh instances, one orbiting
(the port of ``examples/instances.py``).

It runs the two instancing paths:
  * default: the flattened scene; a move refits it, no full build (on
    the bvh intersector of megakernel the host refit, on visit or tvisit
    the device update);
  * ``--tlas``: the two-level TLAS/BLAS traversal (the instances share
    one BLAS; a move refreshes the instance tables).

    python -m rfw_tpu_torch.examples.instances --frames 6 --size 160 \\
        --spp 4 [--tlas] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from rfw_tpu_torch.app import App


class InstanceDemo(App):
    def __init__(self, frames: int, grid: int, tlas: bool, **kw):
        super().__init__(**kw)
        self.frames = frames
        self.grid = grid
        self.tlas = tlas
        self.mover = None
        self.move_times: list[float] = []

    def init(self, rs):
        body = rs.add_material([0.75, 0.55, 0.35], roughness=0.6)
        floor = rs.add_material([0.45, 0.45, 0.5])
        lamp = rs.add_material([35.0, 33.0, 30.0])
        g = rs.add_quad([0, 0, -1], [0, 0.8, 0], 1.2, 1.6, body)
        n = self.grid
        for i in range(n * n):
            t = np.array([(i % n - (n - 1) / 2) * 2.2, 0.0,
                          (i // n - (n - 1) / 2) * 2.2], np.float32)
            ref = rs.add_instance(g, translation=t)
            if i == (n * n) // 2:
                self.mover = ref
        gf = rs.add_quad([0, 1, 0], [0, 0, 0], 6 * n, 6 * n, floor)
        rs.add_instance(gf)
        gl = rs.add_quad([0, -1, 0], [0, 10.0, 0], 4, 4, lamp)
        rs.add_instance(gl)
        if self.tlas:
            rs.set_setting("intersector", "tlas")
        rs.camera.look_at(np.array([0.0, 4.5, -3.2 * n]), np.zeros(3))

    def update(self, rs, dt):
        a = 2.0 * np.pi * self.frame_index / max(self.frames, 1)
        m = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        m[:3, 3] = [1.6 * np.sin(a), 0.6 + 0.3 * np.sin(2 * a),
                    1.6 * np.cos(a)]
        t0 = time.time()
        rs.update_instance(self.mover.index, m)
        rs.synchronize()
        self.move_times.append(time.time() - t0)
        return self.frame_index < self.frames - 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--grid", type=int, default=5)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--engine", default="megakernel")
    ap.add_argument("--tlas", action="store_true",
                    help="two-level TLAS/BLAS instead of the flattened path")
    ap.add_argument("--out", default="instance_frames")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cpu for the CPU)")
    args = ap.parse_args(argv)

    app = InstanceDemo(frames=args.frames, grid=args.grid, tlas=args.tlas,
                       width=args.size, height=args.size,
                       engine=args.engine, output_dir=args.out,
                       camera_file=os.path.join(args.out, "camera.bin"),
                       device=args.device)
    t0 = time.time()
    app.run(frames=args.frames, samples_per_frame=args.spp)
    total = time.time() - t0
    mv = np.mean(app.move_times[1:]) if len(app.move_times) > 1 else 0.0
    print(f"{args.frames} frames ({args.grid}x{args.grid} instances, "
          f"{'tlas' if args.tlas else 'flattened'}, device {app.rs.device}) "
          f"in {total:.1f}s; steady instance move {mv * 1e3:.1f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
