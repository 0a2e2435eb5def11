from .camera import (Camera, make_camera, look_at, generate_rays,
                     resize_camera)
from .geometry import (TriMesh, GeometryTables, build_geometry_tables,
                       make_box, make_quad, make_sphere, scene_bounds)
from .emitters import (EmitterTables, LightSample, PositionSample,
                       build_emitter_tables, sample_light, direct_pdf_tri,
                       emitted_radiance, env_radiance, env_direction_pdf,
                       sample_position, sample_emission_direction,
                       sample_light_ats, direct_pdf_tri_ats)
from .scene import Scene, SceneData, Hit, fill_hit, from_numpy_scene
from .volume import HomogeneousVolume, make_volume
