"""The renderer's integrators, one module an integrator a traffic mix names
(`"integrator": <name>`), found by that name:

  make(params) -> the renderer's integrator, from the configuration's
                  `integrators[<name>]`;
  render(sd, integrator, spp, seed, route) -> one pass's film [h, w, 3]
                  float32 on the host.

Its plain reference is portbench/reference/integrators/<name>.py."""
