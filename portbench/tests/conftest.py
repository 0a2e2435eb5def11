"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
root of the checkout. Tests marked `cuda` need the card and skip without
one, deciding inside the test."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


import json  # noqa: E402
import uuid  # noqa: E402

import pytest  # noqa: E402

PB = os.path.join(ROOT, "portbench")


@pytest.fixture
def tiny_cell():
    """make(config, mix, limits=None) -> (bench, cell): a cell of the
    configuration under a mix written as a new traffic file, with a limits
    file of its own; both are removed after the test. The cell reports
    every end-to-end metric and no per-layer one."""
    made = []

    def make(config, mix, limits=None):
        from portbench import run
        name = f"_t_{uuid.uuid4().hex[:10]}"
        for sub, body in (("traffic", mix), ("limits", limits or {
                "off_share": 0.01, "film_bad": 0, "rtol": 1e-3,
                "atol": 1e-4})):
            path = os.path.join(PB, sub, f"{name}.json")
            with open(path, "w") as f:
                json.dump(body, f)
            made.append(path)
        bench = run.load_benchmark()
        cell = {"name": name, "config": config, "traffic": name, "chips": 1,
                "why": "test"}
        bench["workloads"].append(cell)
        for m in bench["end_to_end"]:
            m.pop("workloads", None)
        return bench, cell

    yield make
    for p in made:
        os.remove(p)
