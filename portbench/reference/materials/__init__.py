"""The reference's materials, one module a kind a configuration's material
names, found by that name (its renderer side is
portbench/materials/<kind>.py). Directions are local to the shading frame
(z along the shading normal); `p` holds each lane's parameters [n, P], the
kind's own in its first columns:

  params(spec) -> the material's parameters, a list of floats;
  evaluate(p, wi, wo) -> (f times the cosine of wo [n, 3], the pdf of
      sampling wo [n]);
  sample(p, wi, u) -> (wo, f cos / pdf [n, 3], pdf [n], delta [n] bool,
      ok [n] bool: a direction was sampled) for u [n, 2]."""
