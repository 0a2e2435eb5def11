from .cbox import cornell_box
from .presets import sphere_grid, sphere_grid_mesh
