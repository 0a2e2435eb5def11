"""Lambertian reflection: spec {"kind": "diffuse", "albedo": [r, g, b]}."""
from rustlight_tpu_torch.bsdfs import diffuse


def make(spec: dict):
    return diffuse(tuple(float(x) for x in spec["albedo"]))
