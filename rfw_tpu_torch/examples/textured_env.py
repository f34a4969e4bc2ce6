"""BASELINE config 3: microfacet BSDF, textured materials and HDR envmap
importance sampling (the port of ``examples/textured_env.py``).

    python -m rfw_tpu_torch.examples.textured_env --size 256 --spp 32 \\
        [--sphere sphere.obj] [--device cpu]

Without ``--sphere`` the two spheres are a level-4 icosphere (5,120
triangles), written as an OBJ into a temporary directory and loaded
through ``add_object`` like any model.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from rfw_tpu_torch.config import RenderConfig
from rfw_tpu_torch.scene import Skybox, Texture
from rfw_tpu_torch.system import RenderSystem
from rfw_tpu_torch.utils import image
from rfw_tpu_torch.utils.synthetic import icosphere


def write_icosphere_obj(path: str, level: int = 4) -> int:
    """The unit icosphere as an OBJ (positions, normals); returns its
    triangle count."""
    verts, faces = icosphere(level)
    with open(path, "w") as f:
        f.write(f"# level-{level} icosphere\n")
        f.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts)
        f.writelines(f"vn {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in verts)
        f.writelines(f"f {a}//{a} {b}//{b} {c}//{c}\n"
                     for a, b, c in faces + 1)
    return len(faces)


def build_scene(rs: RenderSystem, sphere: str) -> None:
    """A checker-textured floor and two metal spheres loaded from
    ``sphere`` under the test sky, and the camera."""
    checker = (np.indices((64, 64)).sum(0) // 8) % 2
    tex = np.stack([checker * 0.75 + 0.15] * 3
                   + [np.ones((64, 64))], -1).astype(np.float32)
    tid = rs.materials.add_texture(Texture.from_array(tex))
    floor = rs.add_material([1, 1, 1], roughness=0.6)
    rs.get_material(floor).maps[0].texture_id = tid

    rough_metal = rs.add_material([0.9, 0.75, 0.4], roughness=0.25,
                                  metallic=1.0)
    shiny = rs.add_material([0.9, 0.9, 0.95], roughness=0.05, metallic=1.0)

    g = rs.add_quad([0, 1, 0], [0, 0, 0], 12, 12, floor)
    rs.add_instance(g)
    s1 = rs.add_object(sphere, material_override=rough_metal,
                       normalize=True)
    rs.add_instance(s1, scale=(2, 2, 2), translation=(-1.4, 1.0, 0))
    s2 = rs.add_object(sphere, material_override=shiny, normalize=True)
    rs.add_instance(s2, scale=(2, 2, 2), translation=(1.4, 1.0, 0))

    # HDR envmap with a strong sun: exercises importance sampling
    rs.set_skybox(Skybox.test_sky(256, 128))

    rs.camera.fov = 45
    rs.camera.look_at([0, 2.2, -6.0], [0, 1.0, 0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="textured_env.png")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--engine", default="megakernel")
    ap.add_argument("--sphere", default=None,
                    help="sphere model (OBJ or any loader's format); "
                         "default a generated level-4 icosphere")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cpu for the CPU)")
    args = ap.parse_args(argv)

    rs = RenderSystem(args.engine, RenderConfig(bsdf="microfacet"),
                      device=args.device)
    rs.camera.resize(args.size, args.size)
    with tempfile.TemporaryDirectory() as tmp:
        sphere = args.sphere
        if sphere is None:
            sphere = os.path.join(tmp, "icosphere.obj")
            n = write_icosphere_obj(sphere)
            print(f"sphere: a generated level-4 icosphere ({n} triangles)")
        else:
            print(f"sphere: {sphere}")
        build_scene(rs, sphere)

    img = rs.render_tonemapped(samples=args.spp)
    image.save_png(args.out, img)
    stats = rs.get_render_stats()
    print(f"{args.size}x{args.size}@{args.spp}spp "
          f"({stats.mrays_per_s():.2f} Mrays/s last batch, device "
          f"{rs.device}) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
