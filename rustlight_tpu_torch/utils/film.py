"""Film plane / AOV buffers; port of rustlight_tpu/utils/film.py.
Images are written by extension through the port's utils/image.py (.pfm,
.exr, .png/.jpg). `splat_add` scatter-adds lane contributions into a
device film with `index_add_`."""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import image as _image
from .image import write_pfm  # noqa: F401  (the PFM writer, as before)


class Film:
    """Host-side film: named AOV buffers ([h, w, c] float32 numpy)."""

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        self.buffers: Dict[str, np.ndarray] = {}

    def register(self, name: str = "primal", channels: int = 3) -> None:
        self.buffers[name] = np.zeros((self.height, self.width, channels),
                                      np.float32)

    def accumulate(self, name: str, values) -> None:
        self.buffers[name] += np.asarray(values, dtype=np.float32)

    def scale(self, s: float, name: str | None = None) -> None:
        for k in [name] if name else list(self.buffers):
            self.buffers[k] = self.buffers[k] * np.float32(s)

    def average_with(self, other: "Film", n_prev: int) -> None:
        """Running average over passes (the reference's avg.rs):
        self = (self * n_prev + other) / (n_prev + 1), buffer by buffer."""
        for k in self.buffers:
            self.buffers[k] = ((self.buffers[k] * n_prev + other.buffers[k])
                               / (n_prev + 1))

    def save(self, path, name: str = "primal") -> None:
        _image.save(path, self.buffers[name])

    def dump_all(self, base_path: str, suffix: str = "") -> None:
        """Write every AOV as <stem>_<name><suffix><ext> beside base_path
        (the reference's dump_all)."""
        p = Path(base_path)
        for k, v in self.buffers.items():
            _image.save(str(p.with_name(f"{p.stem}_{k}{suffix}{p.suffix}")),
                        v)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.buffers[name]


def splat_add(film, pixel_ids, values):
    """Scatter-add lane contributions into a [h*w, c] device film, in
    place, and return it. pixel_ids [n] linear ids (y*width + x) in
    [0, h*w); values [n, c]. Duplicate ids accumulate."""
    return film.index_add_(0, pixel_ids.long(), values)


def accumulate_safe(values):
    """Zero the splats (or per-sample sums) that are non-finite or negative
    in any channel (reference accumulate_safe)."""
    ok = torch.all(torch.isfinite(values) & (values >= 0.0), dim=-1,
                   keepdim=True)
    return torch.where(ok, values, 0.0)
