"""The reference's estimators, one module an integrator a traffic mix names,
found by that name (its renderer side is portbench/integrators/<name>.py):

  values(sc, seed, lanes, spp, params, route) -> the film values [p, 3] of
      pixels `lanes` (y * width + x) in the pass seeded `seed`, replayed
      with the configuration's `integrators[<name>]` settings."""
