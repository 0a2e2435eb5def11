"""Per-layer metrics, one reader a metric: `portbench/metrics/<name>.py`
holds `read(ctx) -> float or None` over the traced stretch's context
(portbench/trace.py). A reader that finds nothing to read returns None."""
import importlib.util
from pathlib import Path


def load(name: str):
    """The `read` of portbench/metrics/<name>.py (names hold dots)."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
