from .camera import Camera, make_camera, look_at, generate_rays
from .geometry import (TriMesh, GeometryTables, build_geometry_tables,
                       make_quad, make_sphere, scene_bounds)
from .emitters import (EmitterTables, LightSample, build_emitter_tables,
                       sample_light, direct_pdf_tri, emitted_radiance)
from .scene import Scene, SceneData, Hit, fill_hit, from_numpy_scene
