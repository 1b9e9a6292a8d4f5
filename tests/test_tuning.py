"""Autotuning defaults (ray_tracer_2_tpu/tuning.py + scripts/apply_tuning.py).

scripts/sweep_knobs.py measures lanes/unroll candidates on the card and
scripts/apply_tuning.py persists the winner into tuned.json; these tests
gate the loader's validation/precedence rules, the backend isolation (CPU
never picks up card-sized lane counts), the kernel-side pickup, and the
sweep-log → tuned.json apply step."""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_2_tpu import tuning
from ray_tracer_2_tpu.kernels.megakernel import render_persistent
from ray_tracer_2_tpu.scene import scenes
from ray_tracer_2_tpu.scene.render_scene import instantiate_scene


@pytest.fixture
def tuned_file(tmp_path, monkeypatch):
    """Point the loader at a scratch tuned.json and clear its cache."""
    path = tmp_path / "tuned.json"
    monkeypatch.setattr(tuning, "TUNED_PATH", path)
    tuning.tuned_defaults.cache_clear()
    yield path
    tuning.tuned_defaults.cache_clear()


def test_checked_in_file_is_valid():
    raw = json.loads(tuning.TUNED_PATH.read_text())
    assert isinstance(raw, dict) and raw, "tuned.json must not be empty"
    for backend, knobs in raw.items():
        assert tuning._validated(knobs) == knobs, \
            f"checked-in knobs for {backend!r} fail validation"


def test_resolve_precedence(tuned_file):
    tuned_file.write_text(json.dumps({"cpu": {"lanes": 512}}))
    assert tuning.resolve("lanes", 1024, 16384) == 1024   # explicit wins
    assert tuning.resolve("lanes", None, 16384) == 512    # tuned next
    assert tuning.resolve("unroll", None, 5) == 5         # fallback last


def test_backend_isolation(tuned_file):
    """Card-measured values must not leak onto other backends (tests and
    the virtual-device mesh run on CPU with tiny scenes)."""
    tuned_file.write_text(json.dumps({"gpu": {"lanes": 65536}}))
    assert tuning.resolve("lanes", None, 16384) == 16384


@pytest.mark.parametrize("content", [
    "not json{", json.dumps(["list"]), json.dumps({"cpu": ["list"]}),
    json.dumps({"cpu": {"lanes": "big"}}),
    json.dumps({"cpu": {"lanes": True}}),
    json.dumps({"cpu": {"lanes": 2, "unroll": 99, "mystery": 1}}),
])
def test_malformed_file_never_fatal(tuned_file, content):
    tuned_file.write_text(content)
    assert tuning.resolve("lanes", None, 16384) == 16384
    assert tuning.resolve("unroll", None, 5) == 5


def test_missing_file(tuned_file):
    assert tuning.resolve("lanes", None, 16384) == 16384


def test_kernel_picks_up_tuned_lanes(tuned_file):
    """render_persistent resolves lanes from tuned.json: iteration count is
    lane-count-dependent (more lanes, fewer iterations) while the image is
    invariant — assert both against an explicit-lanes render."""
    tuned_file.write_text(json.dumps({"cpu": {"lanes": 128}}))
    rs = instantiate_scene(scenes.metal()).render_scene
    kw = dict(width=24, height=12, bounces=2, rays_per_pixel=1, skybox=True,
              return_iters=True)
    img_t, segs_t, it_t = render_persistent(rs, jnp.int32(1), **kw)
    img_128, segs_128, it_128 = render_persistent(rs, jnp.int32(1), lanes=128,
                                                  **kw)
    img_512, _, it_512 = render_persistent(rs, jnp.int32(1), lanes=512, **kw)
    assert int(it_t) == int(it_128) != int(it_512)
    assert (np.asarray(img_t) == np.asarray(img_128)).all()
    assert (np.asarray(img_t) == np.asarray(img_512)).all()
    assert float(segs_t) == float(segs_128)


# ---------------------------------------------------------- apply step --

def _load_apply():
    path = Path(__file__).resolve().parents[1] / "scripts" / "apply_tuning.py"
    spec = importlib.util.spec_from_file_location("apply_tuning", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log_lines(rows):
    return [json.dumps(r) for r in rows]


def test_best_config_parses_sweep_log():
    mod = _load_apply()
    rows = [
        {"scene": "dragon", "env": {}, "kw": None, "mrays": 19.4},
        {"scene": "dragon", "env": {"RT2_X": "1"}, "kw": None, "mrays": 99.0},
        {"scene": "sponza", "env": {}, "kw": None, "mrays": 15.0},
        {"scene": "dragon", "env": {}, "kw": {"lanes": 32768}, "mrays": 22.1},
        {"scene": "dragon", "env": {}, "kw": {"unroll": 4}, "mrays": 18.0},
        {"scene": "dragon", "env": {}, "kw": None, "error": "boom"},
    ]
    base, kw, mrays = mod.best_config(_log_lines(rows), "dragon")
    assert base == 19.4                      # env variants excluded
    assert kw == {"lanes": 32768} and mrays == 22.1


def test_best_config_later_rerun_supersedes():
    mod = _load_apply()
    rows = [
        {"scene": "dragon", "env": {}, "kw": {"lanes": 32768}, "mrays": 50.0},
        {"scene": "dragon", "env": {}, "kw": {"lanes": 32768}, "mrays": 10.0},
        {"scene": "dragon", "env": {}, "kw": None, "mrays": 19.0},
    ]
    base, kw, mrays = mod.best_config(_log_lines(rows), "dragon")
    assert (kw, mrays) == ({"lanes": 32768}, 10.0)


@pytest.mark.parametrize("win_mrays,expect_written", [(30.0, True),
                                                      (19.5, False)])
def test_apply_writes_only_on_margin(tuned_file, tmp_path, monkeypatch,
                                     win_mrays, expect_written):
    mod = _load_apply()
    monkeypatch.setattr(mod.tuning, "TUNED_PATH", tuned_file)
    tuned_file.write_text(json.dumps({"gpu": {"lanes": 16384, "unroll": 5}}))
    log = tmp_path / "sweep.log"
    log.write_text("\n".join(_log_lines([
        {"scene": "dragon", "env": {}, "kw": None, "mrays": 19.4},
        {"scene": "dragon", "env": {}, "kw": {"lanes": 32768},
         "mrays": win_mrays},
    ])))
    monkeypatch.setattr("sys.argv", ["apply_tuning.py", str(log), "--scene",
                                     "dragon", "--backend", "gpu"])
    assert mod.main() == 0
    got = json.loads(tuned_file.read_text())["gpu"]
    if expect_written:
        assert got == {"lanes": 32768, "unroll": 5}  # merge keeps unroll
    else:
        assert got == {"lanes": 16384, "unroll": 5}


def test_scene_class_profile_overrides(tmp_path, monkeypatch):
    """"<backend>:<profile>" entries override the plain backend defaults
    knob-by-knob; unrelated knobs fall through."""
    import json

    from ray_tracer_2_tpu import tuning

    p = tmp_path / "tuned.json"
    p.write_text(json.dumps({
        "cpu": {"lanes": 2048, "unroll": 4},
        "cpu:textured": {"lanes": 4096},
    }))
    monkeypatch.setattr(tuning, "TUNED_PATH", p)
    tuning.tuned_defaults.cache_clear()
    try:
        assert tuning.resolve("lanes", None, 1, profile="textured") == 4096
        assert tuning.resolve("unroll", None, 1, profile="textured") == 4
        assert tuning.resolve("lanes", None, 1) == 2048
        assert tuning.resolve("lanes", 512, 1, profile="textured") == 512
    finally:
        tuning.tuned_defaults.cache_clear()
