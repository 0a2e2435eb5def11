from .cbox import cornell_box
from .presets import (door_box, furnace_scene, simple_sphere_scene,
                      sphere_grid, sphere_grid_mesh)
from .veach import veach_mis
