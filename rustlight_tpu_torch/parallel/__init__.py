from .mesh import (Mesh, agree, gather_axis, gather_objects, gather_rows,
                   halo_rows, make_device_mesh, run_on_mesh, sum_over_ranks)
from .render import (adaptive_step_sharded, render_block_sharded,
                     render_sharded, render_splat_sharded, render_step_sharded,
                     render_variance_sharded, splat_step_sharded)
