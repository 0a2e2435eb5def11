"""End-to-end wall of the 4.9M-triangle AO scene; the port's counterpart of
the JAX package's tools/perf/e2e_4p9M.py.

sphere_grid_mesh(4_200_000, n_theta=18) (8,000 UV spheres of 612
triangles, 4,896,000 triangles, diffuse 0.65 0.6 0.55, no emitter; bench.py's
grid4p9M) seen from outside at 256x256: the AO integrator (max_distance 2)
at 4 spp, cold and warm (tools/perf/e2e_131k.py:cold_warm), with the image
mean; `--spp` adds the path tracer. The scene's clusters are held to what
the reference's build gives it, 16,000 (`--clusters`; 0 skips the check):
not past 2^14, so the one-level walk, where the reference's script asserted
the opposite. The last image goes to build/lab/bigscene_4p9M.png.

    python -m rustlight_tpu_torch.tools.perf.e2e_4p9M [--ao-spp 4]
        [--device cpu]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

from ...bsdfs import diffuse
from ...models.presets import sphere_grid_mesh
from ...scene import Scene, look_at, make_camera
from ...utils.image import save
from . import common
from .e2e_131k import parser, renders

FLAT_CLUSTERS = 1 << 14


def ao_grid(tris: int, theta: int, res: int) -> Scene:
    """The scene: the sphere grid, no emitter, the camera outside looking
    at its centre (fov 55)."""
    sc = Scene()
    m = sc.add_material(diffuse((0.65, 0.6, 0.55)))
    mesh, gs = sphere_grid_mesh(tris, n_theta=theta, material=m)
    sc.add_mesh(mesh)
    ext = gs * 3.0
    sc.camera = make_camera(res, res, fov=55.0,
                            to_world=look_at((ext / 2, ext / 2, -0.35 * ext),
                                             (ext / 2, ext / 2, ext / 2),
                                             (0, 1, 0)))
    return sc


def main(argv=None) -> dict:
    p = parser(__doc__, "e2e_4p9M_h100.json", 4_200_000, 0, 4)
    p.add_argument("--theta", type=int, default=18)
    p.add_argument("--clusters", type=int, default=16_000,
                   help="the real clusters the build must give (0: any)")
    p.add_argument("--png", default=str(common.OUT_DIR
                                        / "bigscene_4p9M.png"))
    args = p.parse_args(argv)
    dev = common.pick_device(args.device)
    t0 = time.perf_counter()
    sd = ao_grid(args.tris, args.theta, args.res).compile(device=dev)
    compile_s = time.perf_counter() - t0
    wt = sd.geom.walk
    print(f"compile(scene) {compile_s:.1f}s tris={sd.geom.n_tris} "
          f"clusters={wt.n_real} (Cp {wt.n_clusters})", flush=True)
    if args.clusters and not (wt.n_real == args.clusters
                              and wt.n_clusters <= FLAT_CLUSTERS):
        raise AssertionError(
            f"{wt.n_real} clusters (Cp {wt.n_clusters}): the reference's "
            f"build gives this scene {args.clusters}, within 2^14")
    out, img = renders(args, sd, dev)
    rec = {**common.device_record(dev), "tris": int(sd.geom.n_tris),
           "clusters": int(wt.n_real), "cp": int(wt.n_clusters),
           "res": args.res, "compile_s": compile_s, **out}
    if img is not None:
        Path(args.png).parent.mkdir(parents=True, exist_ok=True)
        save(args.png, img)
        rec["png"] = args.png
        print(f"saved {args.png}", flush=True)
    common.write_record(args.out, rec)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
