"""BASELINE config 4: an animated skinned glTF, posed every frame (the
port of ``examples/animation.py``). Reports the scene update and frame
rates.

    python -m rfw_tpu_torch.examples.animation --frames 8 --size 160 \\
        --spp 4 [--model CesiumMan.gltf] [--device cpu]

Without ``--model`` it renders a skinned tube of 65,536 triangles whose
upper joint bends over time (``utils/synthetic.write_skinned_gltf``,
from a fixed seed), written as a glTF into a temporary directory and
loaded through ``add_object`` like any model. It says on stdout which
model it rendered.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from rfw_tpu_torch.app import App
from rfw_tpu_torch.scene import Skybox
from rfw_tpu_torch.utils.synthetic import write_skinned_gltf

SEED = 20261016


class AnimDemo(App):
    def __init__(self, frames: int, model: str, **kw):
        super().__init__(**kw)
        self.frames = frames
        self.model = model
        self.update_times: list[float] = []

    def init(self, rs):
        ref = rs.add_object(self.model)
        rs.add_instance(ref)
        floor = rs.add_material([0.5, 0.5, 0.55])
        g = rs.add_quad([0, 1, 0], [0, 0, 0], 10, 10, floor)
        rs.add_instance(g)
        rs.add_directional_light([0.4, -1.0, 0.3], [2.5, 2.4, 2.2])
        rs.set_skybox(Skybox.test_sky(128, 64))
        verts = np.concatenate(
            [m.positions for m in ref.object.meshes])
        c = verts.mean(0)
        rs.camera.look_at(c + np.array([1.2, 0.6, 2.4]), c)

    def update(self, rs, dt):
        t0 = time.time()
        rs.set_animations_to(self.frame_index * (1.0 / 12.0))
        rs.synchronize()
        self.update_times.append(time.time() - t0)
        return self.frame_index < self.frames - 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--engine", default="megakernel")
    ap.add_argument("--out", default="anim_frames")
    ap.add_argument("--model", default=None,
                    help="skinned glTF to animate (CesiumMan in the "
                         "reference); default a generated skinned tube")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cpu for the CPU)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        model = args.model
        if model is None:
            model = os.path.join(tmp, "tube.gltf")
            n = write_skinned_gltf(model, SEED)
            print(f"model: a generated skinned tube ({n} triangles, seed "
                  f"{SEED})")
        else:
            print(f"model: {model}")
        app = AnimDemo(frames=args.frames, model=model, width=args.size,
                       height=args.size, engine=args.engine,
                       output_dir=args.out,
                       camera_file=os.path.join(args.out, "camera.bin"),
                       device=args.device)
        t0 = time.time()
        app.run(frames=args.frames, samples_per_frame=args.spp)
        total = time.time() - t0
    upd = np.mean(app.update_times) if app.update_times else 0.0
    print(f"{args.frames} frames in {total:.1f}s "
          f"({args.frames / total:.2f} fps incl. the build; device "
          f"{app.rs.device}); scene update {upd * 1e3:.1f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
