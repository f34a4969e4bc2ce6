"""Cornell box, the scene of BASELINE configs 1 and 2, built procedurally
with quads through the engine ABI (the port of ``examples/cornell.py``).

    python -m rfw_tpu_torch.examples.cornell --out cornell.png --size 256 \\
        --spp 16 --engine megakernel [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from rfw_tpu_torch.camera import Camera
from rfw_tpu_torch.ops import tonemap
from rfw_tpu_torch.render import RenderStatus, create_engine
from rfw_tpu_torch.scene import HostMaterial, MaterialList, make_quad
from rfw_tpu_torch.scene.lights import AreaLight, pack_lights
from rfw_tpu_torch.utils import image


def build_cornell(engine, light_radiance=(30.0, 30.0, 30.0)):
    """Classic box: white floor, ceiling and back wall, red left and green
    right wall, an emissive quad under the ceiling, uploaded to
    ``engine`` with the lamp's two triangles as area lights. Returns the
    MaterialList."""
    ml = MaterialList()
    white = ml.add(HostMaterial(name="white", roughness=1.0,
                                color=np.array([0.73, 0.73, 0.73])))
    red = ml.add(HostMaterial(name="red", roughness=1.0,
                              color=np.array([0.63, 0.065, 0.05])))
    green = ml.add(HostMaterial(name="green", roughness=1.0,
                                color=np.array([0.14, 0.45, 0.091])))
    light = ml.add(HostMaterial(name="light",
                                color=np.asarray(light_radiance)))

    quads = [
        make_quad([0, 1, 0], [0, 0, 0], 5.56, 5.56, white),      # floor
        make_quad([0, -1, 0], [0, 5.48, 0], 5.56, 5.56, white),  # ceiling
        make_quad([0, 0, -1], [0, 2.74, 2.796], 5.56, 5.48, white),  # back
        make_quad([1, 0, 0], [-2.78, 2.74, 0], 5.48, 5.56, red),     # left
        make_quad([-1, 0, 0], [2.78, 2.74, 0], 5.48, 5.56, green),   # right
        make_quad([0, -1, 0], [0, 5.47, 0], 1.3, 1.05, light),       # lamp
    ]

    area_lights = []
    overrides = {}
    for slot, q in enumerate(quads):
        engine.set_mesh(slot, q.triangles())
        engine.set_instance(slot, slot, np.eye(4, dtype=np.float32))
    # the lamp's two triangles as area lights (what
    # RenderSystem._update_area_lights does, inline here)
    lamp_tris = quads[-1].triangles()
    lamp_slot = len(quads) - 1
    for i in range(lamp_tris.count):
        v = lamp_tris.vertices[i]
        area_lights.append(AreaLight(
            vertex0=v[0], vertex1=v[1], vertex2=v[2],
            normal=lamp_tris.gnormal[i],
            radiance=np.asarray(light_radiance, np.float32),
            area=float(lamp_tris.area[i]), tri_idx=i, inst_idx=lamp_slot))
        overrides[(lamp_slot, i)] = i

    engine.set_materials(ml.generate_device_materials())
    engine.set_lights(pack_lights(area_lights, [], [], []),
                      overrides=overrides)
    return ml


def default_camera(size: int) -> Camera:
    cam = Camera()
    cam.resize(size, size)
    cam.fov = 40.0
    cam.look_at([0.0, 2.73, -8.0], [0.0, 2.73, 0.0])
    return cam


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="cornell.png")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--engine", default="megakernel")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cpu for the CPU)")
    args = ap.parse_args(argv)

    engine = create_engine(args.engine, device=args.device)
    build_cornell(engine)
    cam = default_camera(args.size)
    engine.resize(args.size, args.size)
    hdr = engine.render_frame(cam.get_view().as_pytree(), RenderStatus.RESET,
                              samples=args.spp)
    stats = engine.get_stats()
    print(f"rendered {args.size}x{args.size}@{args.spp}spp in "
          f"{stats.render_time:.2f}s — {stats.mrays_per_s():.2f} Mrays/s "
          f"(engine={args.engine}, device={engine.device})")
    ldr = tonemap.tonemap(torch.as_tensor(hdr, device=engine.device),
                          cam.brightness, cam.contrast)
    image.save_png(args.out, ldr.cpu().numpy())
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
