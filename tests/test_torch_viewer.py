"""The port's progressive viewer (rustlight_tpu_torch/tools/viewer.py)
against the JAX package's tools/viewer.py, on the CPU.

  - the in-browser tracer's export: scene_to_web_json equal to the JAX
    viewer's on cbox, veach_mis and every example scene it takes, and the
    same WebExportError on the ones it refuses (a medium, a point-normal
    light, an env map over 256x256, a smooth substrate);
  - _orbit_camera within 1e-6 of the JAX one, on a host and a device
    camera; the served web_tracer.js byte for byte tools/web_tracer.js;
  - two passes of make_interactive_step at cbox 16x16 within 1e-5 of the
    JAX step's (jitted once, in a module fixture), on the same tables;
  - the server (port 0, cbox 16x16, the CPU): progressive accumulation,
    the PNG equal to tonemap_gamma of the running average, an orbit that
    restarts accumulation with `uploads` still 1 and whose first pass is
    one compute_pixel pass with the orbit camera, pause and resume, the
    /local endpoints; the fixture's teardown stops both threads;
  - an error in a pass ends the loop and shows in the state.
"""
import hashlib
import importlib.util
import json
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from rustlight_tpu_torch.tools import viewer
from rustlight_tpu_torch.utils.image import decode_png, tonemap_gamma

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 20.0


@pytest.fixture(scope="module")
def jv():
    """tools/viewer.py of the JAX package, under a name of its own (its
    module state apart from tests/test_viewer.py's)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_tool_viewer", ROOT / "tools" / "viewer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _norm(desc):
    return json.loads(json.dumps(desc))


def _both(jv, make_jax, make_port):
    """The export of both packages (or its error message)."""
    out = []
    for mod, make in ((jv, make_jax), (viewer, make_port)):
        try:
            out.append(_norm(mod.scene_to_web_json(make())))
        except mod.WebExportError as e:
            out.append(("WebExportError", str(e)))
    return out


EXAMPLES = sorted(p.name for p in (ROOT / "examples").iterdir()
                  if p.suffix in (".pbrt", ".xml", ".obj"))


@pytest.mark.parametrize("name", ["cbox", "veach_mis"] + EXAMPLES)
def test_web_export_matches_jax(jv, name):
    if name == "cbox":
        from rustlight_tpu.models import cornell_box as jm
        from rustlight_tpu_torch.models import cornell_box as tm
        args = (24, 16)
    elif name == "veach_mis":
        from rustlight_tpu.models import veach_mis as jm
        from rustlight_tpu_torch.models import veach_mis as tm
        args = (32, 24)
    else:
        from rustlight_tpu.scene.loaders import load_scene as jm
        from rustlight_tpu_torch.scene.loaders import load_scene as tm
        args = (str(ROOT / "examples" / name),)
    a, b = _both(jv, lambda: jm(*args), lambda: tm(*args))
    assert a == b
    if name in ("cbox", "veach_mis", "cbox.pbrt"):
        assert isinstance(b, dict) and len(b["v0"]) > 0


def _refused(kind):
    """A scene of each package that the export refuses: (jax, port)."""
    out = []
    for pkg in ("rustlight_tpu", "rustlight_tpu_torch"):
        models = __import__(f"{pkg}.models", fromlist=["cornell_box"])
        scene_mod = __import__(f"{pkg}.scene", fromlist=["make_volume"])
        bsdfs = __import__(f"{pkg}.bsdfs", fromlist=["substrate"])
        sc = models.cornell_box(16, 16)
        if kind == "medium":
            sc.volume = scene_mod.make_volume(sigma_s=(0.01,) * 3,
                                              sigma_a=(0.001,) * 3, g=0.0)
        elif kind == "point-normal":
            sc.point_normal_lights.append(((278.0, 500.0, 279.0),
                                           (0.0, -1.0, 0.0), (5.0,) * 3))
        elif kind == "env-too-large":
            sc.env_image = np.ones((512, 512, 3), np.float32)
        else:
            sc = models.cornell_box(16, 16, mat_overrides={
                "white": bsdfs.substrate(alpha=0.0)})
        out.append(sc)
    return out


@pytest.mark.parametrize("kind,match", [
    ("medium", "media"), ("point-normal", "point-normal"),
    ("env-too-large", "too large"), ("smooth-substrate", "smooth substrate")])
def test_web_export_refuses_what_jax_refuses(jv, kind, match):
    js, ts = _refused(kind)
    a, b = _both(jv, lambda: js, lambda: ts)
    assert a == b and a[0] == "WebExportError" and match in a[1]


def test_orbit_camera_matches_jax(jv):
    from rustlight_tpu.scene.camera import look_at as jlook, make_camera as jmc
    from rustlight_tpu_torch.scene.camera import camera_to, look_at, make_camera
    state = dict(theta=0.7, phi=0.3, radius=5.0,
                 target=np.array([0.1, 0.2, -0.3], np.float32),
                 up=np.array([0.0, 1.0, 0.0], np.float32))
    jv._ORBIT.update(state)
    viewer._ORBIT.update(state)
    jcam = jv._orbit_camera(jmc(32, 24, 45.0, jlook((0, 1, -4), (0, 1, 0),
                                                     (0, 1, 0))))
    host = make_camera(32, 24, 45.0, look_at((0, 1, -4), (0, 1, 0),
                                             (0, 1, 0)))
    for cam in (host, camera_to(host, "cpu")):
        got = viewer._orbit_camera(cam)
        for f in ("to_world", "to_local"):
            np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                       np.asarray(getattr(jcam, f)),
                                       rtol=0, atol=1e-6)
        assert got.sample_to_camera is cam.sample_to_camera
        assert type(got.to_world) is type(cam.to_world)
    eye = np.asarray(got.to_world)[:3, 3]
    assert np.linalg.norm(eye - state["target"]) == pytest.approx(5.0,
                                                                  rel=1e-5)


@pytest.fixture(scope="module")
def jax_passes(jv):
    """The JAX step at cbox 16x16 (depth 3), jitted once: its scene and
    its passes 0 and 1."""
    from rustlight_tpu.integrators import IntegratorPathTracing as JPath
    from rustlight_tpu.models import cornell_box
    jsd = cornell_box(16, 16).compile()
    jstep, jcam = jv.make_interactive_step(jsd, JPath(max_depth=3))
    return jsd, [np.asarray(jstep(jcam, p)) for p in (0, 1)]


def test_interactive_step_matches_jax(jax_passes):
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.scene import from_numpy_scene
    jsd, passes = jax_passes
    tsd = from_numpy_scene(jsd.host.data, "cpu")
    tstep, tcam = viewer.make_interactive_step(
        tsd, IntegratorPathTracing(max_depth=3))
    for p, want in enumerate(passes):
        got = tstep(tcam, p).numpy()
        assert got.shape == want.shape == (256, 3)
        assert want.max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert tstep.uploads == 1


class _Failing:
    def compute_pixel(self, scene, pix, stream):
        raise FloatingPointError("planted failure")


def test_a_failing_pass_ends_the_loop():
    from rustlight_tpu_torch.models import cornell_box
    saved = dict(viewer._STATE)
    try:
        viewer._STATE.update(viewer._initial_state())
        sd = cornell_box(8, 8).compile(device="cpu")
        with pytest.raises(FloatingPointError, match="planted"):
            viewer._render_loop(sd, _Failing())
        assert "planted failure" in viewer._STATE["error"]
        assert not viewer._STATE["busy"]
    finally:
        viewer._STATE.update(saved)


def test_step_needs_compute_pixel():
    from rustlight_tpu_torch.integrators import IntegratorLightTracing
    from rustlight_tpu_torch.models import cornell_box
    sd = cornell_box(8, 8).compile(device="cpu")
    with pytest.raises(ValueError, match="compute_pixel"):
        viewer.make_interactive_step(sd, IntegratorLightTracing())


# ---- the server


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _wait(pred, timeout=DEADLINE_S):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if viewer._STATE["error"]:
            raise AssertionError(viewer._STATE["error"])
        if pred():
            return True
        time.sleep(0.02)
    return False


def _state(port):
    return json.loads(_get(port, "/api/state"))


def _pause(port):
    """Pause and wait until no pass is in flight."""
    _post(port, "/api/pause", {"paused": True})
    assert _wait(lambda: viewer._STATE["paused"]
                 and not viewer._STATE["busy"])


@pytest.fixture(scope="module")
def server():
    srv = viewer.main(["cbox", "--port", "0", "--host", "127.0.0.1",
                       "--res", "0.03125", "--device", "cpu", "--", "path",
                       "-m", "3"], block=False)
    yield srv.server_address[1]
    assert viewer.stop(srv)
    assert viewer._STATE["error"] is None


def test_progressive_accumulation(server):
    port = server
    assert _wait(lambda: viewer._STATE["spp"] >= 3)
    st = _state(port)
    assert st["width"] == 16 and st["height"] == 16
    assert st["spp"] >= 3 and st["backend"] == "cpu"
    assert st["uploads"] == 1 and st["error"] is None
    png = _get(port, "/img.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    page = _get(port, "/").decode()
    assert "api/orbit" in page and "img.png" in page


def test_frame_is_the_running_average(server):
    port = server
    assert _wait(lambda: viewer._STATE["spp"] >= 2)
    _pause(port)
    try:
        px = decode_png(_get(port, "/img.png"))
        assert px.shape == (16, 16, 3)
        np.testing.assert_array_equal(px, tonemap_gamma(viewer._FRAME["avg"]))
    finally:
        _post(port, "/api/pause", {"paused": False})


def test_orbit_resets_and_keeps_the_upload(server):
    port = server
    assert _wait(lambda: viewer._STATE["spp"] >= 5)
    _pause(port)
    png_before = _get(port, "/img.png")
    old, seq0 = viewer._FRAME["first_cam"], viewer._STATE["seq"]
    tables = [t.data_ptr() for t in viewer._tensors(old, [])]
    _post(port, "/api/orbit", {"dtheta": 1.2, "dzoom": 0.8})
    assert _wait(lambda: not viewer._ORBIT["dirty"])   # taken while paused
    _post(port, "/api/pause", {"paused": False})
    # accumulation restarts at the new pose: the first frame after the
    # resume is its first pass
    assert _wait(lambda: viewer._STATE["seq"] > seq0)
    assert viewer._FRAME["first_cam"] is not old
    assert _wait(lambda: viewer._STATE["spp"] >= 5)
    st = _state(port)
    assert st["uploads"] == 1, st["uploads"]
    assert _get(port, "/img.png") != png_before       # the camera moved
    cam = viewer._FRAME["first_cam"]
    assert viewer._FRAME["first_pass"] == 0
    assert [t.data_ptr() for t in viewer._tensors(cam, [])] != tables
    # the first pass at the new pose: one compute_pixel pass, pass index 0
    from rustlight_tpu_torch.integrators import IntegratorPathTracing
    from rustlight_tpu_torch.models import cornell_box
    sd = cornell_box(16, 16).compile(device="cpu")
    step, _ = viewer.make_interactive_step(sd, IntegratorPathTracing(
        max_depth=3))
    want = step(sd.camera._replace(to_world=cam.to_world,
                                   to_local=cam.to_local), 0).numpy()
    np.testing.assert_allclose(viewer._FRAME["first"], want, rtol=0,
                               atol=1e-6)


def test_pause_and_resume(server):
    port = server
    _pause(port)
    spp = _state(port)["spp"]
    time.sleep(0.5)
    assert _state(port)["spp"] == spp
    _post(port, "/api/pause", {"paused": False})
    assert _wait(lambda: viewer._STATE["spp"] > spp)


def test_local_tracer_endpoints(server):
    port = server
    page = _get(port, "/local").decode()
    assert "web_tracer.js" in page and "renderBlock" in page
    assert "canvas" in page
    js = _get(port, "/web_tracer.js")
    assert hashlib.sha256(js).hexdigest() == hashlib.sha256(
        (ROOT / "tools" / "web_tracer.js").read_bytes()).hexdigest()
    desc = json.loads(_get(port, "/api/scene.json"))
    assert len(desc["v0"]) == len(desc["e1"]) == len(desc["e2"]) > 0
    assert desc["cam"]["width"] == viewer._STATE["width"] == 16
    assert desc["cam"]["height"] == viewer._STATE["height"] == 16
    assert sum(desc["atom_prob"]) == pytest.approx(1.0)
    assert len(desc["em_tri"]) > 0
    assert "/local" in _get(port, "/").decode()
