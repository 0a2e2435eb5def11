"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or rustlight_tpu (compared whole: rustlight_tpu_torch is the
renderer under test), and nothing of the renderer in the reference."""
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PB = os.path.join(ROOT, "portbench")


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    return set(out.stdout.split())


def _by_path(sub):
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(PB, sub, "*.py"))
                  if not os.path.basename(p).startswith("_"))


def test_harness_loads_no_jax():
    code = ["import portbench.run as r, portbench.window, portbench.check",
            "import portbench.port, portbench.trace, portbench.control",
            "import portbench.scene as s, portbench.roofline"]
    code += ["import portbench.metrics as pm"]
    code += [f"pm.load({m!r})" for m in _by_path("metrics")]
    code += [f"import portbench.{sub.replace('/', '.')}.{m}"
             for sub in ("shapes", "materials", "integrators",
                         "reference/materials", "reference/integrators")
             for m in _by_path(sub)]
    code += [f"s.build_arrays(s.load_config({os.path.splitext(c)[0]!r}))"
             for c in sorted(os.listdir(os.path.join(PB, "configs")))]
    code += ["import portbench.window as w"]
    code += [f"w.load_traffic({os.path.splitext(t)[0]!r})"
             for t in sorted(os.listdir(os.path.join(PB, "traffic")))
             if not t.startswith("_")]
    loaded = _loaded_after("\n".join(code))
    assert "rustlight_tpu_torch" in loaded     # the system under test
    assert not loaded & {"jax", "jaxlib", "flax", "rustlight_tpu"}


def test_reference_loads_nothing_of_the_renderer():
    code = ["import portbench.reference.scene, portbench.reference.rng",
            "import portbench.check, portbench.control"]
    code += [f"import portbench.reference.{sub}.{m}"
             for sub in ("materials", "integrators")
             for m in _by_path(f"reference/{sub}")]
    code += ["import portbench.scene as s",         # a replay, in full
             "cfg = s.load_config('cbox')",
             "a = s.build_arrays(cfg)",
             "for k in cfg['integrators']:",
             "    portbench.check.reference_values(a, cfg, {"
             "'integrator': k, 'route': 'per_pass', 'width': 4, "
             "'height': 3, 'spp_per_pass': 1}, [1], [0, 5], 'cpu')"]
    loaded = _loaded_after("\n".join(code))
    assert not loaded & {"rustlight_tpu_torch", "rustlight_tpu", "jax",
                         "jaxlib", "flax"}


def test_run_refuses_without_a_card():
    """Without CUDA the run exits non-zero and prints no result."""
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "cbox.path.hd",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, env={**os.environ,
                                             "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
