"""Host-side pieces of running on the GPU, checked on the CPU: the compile
cache helper, the device checks of the measurement entry points, the
stdlib PNG codec, hash-keyed native builds, and the numerics the card
would otherwise change (f16 decode, full-precision float32 products)."""
import importlib.util
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tracer_2_tpu.engine.export import read_png, save_png, write_png
from ray_tracer_2_tpu.utils import compile_cache, native_build
from ray_tracer_2_tpu.utils.device import require_gpu

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------- compile cache --

@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_respects_env(monkeypatch, tmp_path,
                                    restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left alone


def test_cache_dir_is_ignored_by_git():
    lines = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in lines and "chiprun_out/" in lines


# ---------------------------------------------------------- device checks --

def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="platform 'cpu'"):
        require_gpu("tool")


def test_require_gpu_allows_explicit_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert require_gpu("tool", allow_explicit_cpu=True)["platform"] == "cpu"
    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(SystemExit, match="JAX_PLATFORMS=cpu"):
        require_gpu("tool", allow_explicit_cpu=True)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name.removesuffix(".py"),
                                                  ROOT / name)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_without_gpu(capsys):
    """On the CPU the smoke check exits non-zero, names the platform, and
    prints no result line."""
    smoke = _load_script("chip_smoke.py")
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code not in (0, None)
    assert "platform 'cpu'" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_rejects_unknown_phase():
    smoke = _load_script("chip_smoke.py")
    with pytest.raises(SystemExit) as e:
        smoke.main(["--phases", "nope"])
    assert e.value.code == 2


# ----------------------------------------------------------------- PNG --

@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(tmp_path, channels):
    img = np.random.default_rng(0).integers(
        0, 256, (7, 5, channels)).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(path, img)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(read_png(path), img)


def test_png_matches_pil_decoder(tmp_path):
    """Interoperability: a third-party decoder reads what we write."""
    Image = pytest.importorskip("PIL.Image")
    fb = np.random.default_rng(1).random((9, 11, 4)).astype(np.float32)
    path = tmp_path / "fb.png"
    save_png(fb, path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), read_png(path))


def test_png_reader_handles_every_filter(tmp_path):
    """Rows filtered with Sub/Up/Average/Paeth (as other encoders write
    them) decode to the same pixels as filter 0."""
    import struct
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (6, 4, 3)).astype(np.int32)
    h, w, c = img.shape
    flat = img.reshape(h, w * c)
    rows = []
    for y in range(h):
        kind = y % 5
        prev = flat[y - 1] if y else np.zeros(w * c, np.int32)
        out = np.zeros(w * c, np.int32)
        for x in range(w * c):
            a = flat[y, x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            pred = [0, a, b, (a + b) // 2, paeth][kind]
            out[x] = (flat[y, x] - pred) & 0xFF
        rows.append(bytes([kind]) + out.astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path = tmp_path / "f.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(read_png(path), img.astype(np.uint8))


def test_png_reader_rejects_corruption(tmp_path):
    path = tmp_path / "c.png"
    write_png(path, np.zeros((2, 2, 3), np.uint8))
    data = bytearray(path.read_bytes())
    data[-20] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        read_png(path)


# ------------------------------------------------------ native builds --

def test_native_build_key_tracks_source_and_flags(tmp_path):
    src = tmp_path / "lib.cpp"
    src.write_text("int f() { return 1; }\n")
    k = native_build.build_key(src, ["-O3"])
    assert native_build.build_key(src, ["-O2"]) != k
    src.write_text("int f() { return 2; }\n")
    assert native_build.build_key(src, ["-O3"]) != k


def test_native_build_never_loads_a_foreign_build(tmp_path, monkeypatch):
    """A .so built for another host (or from other source) has another
    name, so it is rebuilt rather than loaded."""
    src = tmp_path / "lib.cpp"
    src.write_text('extern "C" int f() { return 7; }\n')
    flags = ["-O1", "-shared", "-fPIC"]
    monkeypatch.setattr(native_build.platform, "node", lambda: "host-a")
    so_a = native_build.build_shared_lib(src, flags)
    if so_a is None:
        pytest.skip("no working g++ here")
    monkeypatch.setattr(native_build.platform, "node", lambda: "host-b")
    so_b = native_build.build_shared_lib(src, flags)
    assert so_a != so_b and so_a.exists() and so_b.exists()
    assert not list(tmp_path.glob("*.tmp"))


# ------------------------------------------------------------ numerics --

def test_f16_decode_exact_for_every_pattern():
    from ray_tracer_2_tpu.kernels.megakernel import f16_bits_to_f32
    bits = np.arange(65536, dtype=np.uint32)
    want = bits.astype(np.uint16).view(np.float16).astype(np.float32)
    got = np.asarray(jax.jit(f16_bits_to_f32)(jnp.asarray(bits)))
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


def test_float32_products_ask_for_full_precision():
    """The instance transforms and the camera ray request HIGHEST (a GPU
    would otherwise run them in TF32), and match float64 to 1e-6."""
    from ray_tracer_2_tpu.kernels.megakernel import _matvec
    from ray_tracer_2_tpu.kernels.trace import camera_ray_basis
    from ray_tracer_2_tpu.scene import scenes
    from ray_tracer_2_tpu.scene.render_scene import instantiate_scene

    rng = np.random.default_rng(3)
    m = rng.normal(size=(64, 3, 3)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32) * 10
    hlo = jax.jit(_matvec).lower(m, v).as_text()
    assert "HIGHEST" in hlo
    got = np.asarray(_matvec(jnp.asarray(m), jnp.asarray(v)))
    want = np.einsum("bij,bj->bi", m.astype(np.float64), v.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    rs = instantiate_scene(scenes.room()).render_scene
    x = jnp.arange(16, dtype=jnp.int32)
    y = jnp.full((16,), 7, jnp.int32)
    hlo = jax.jit(lambda s: camera_ray_basis(s, x, y, 16, 9)[3]).lower(
        rs).as_text()
    assert "HIGHEST" in hlo
    fp = np.asarray(camera_ray_basis(rs, x, y, 16, 9)[3], np.float64)
    cam = np.asarray(rs.cam_to_world, np.float64)
    vp = np.asarray(rs.view_params, np.float64)
    uv = np.stack([np.arange(16) / 15.0, np.full(16, 7 / 8.0)], axis=1)
    local = np.stack([(uv[:, 0] - 0.5) * vp[0], (uv[:, 1] - 0.5) * vp[1],
                      np.full(16, vp[2])], axis=1)
    want = local @ cam[:3, :3].T + cam[:3, 3]
    np.testing.assert_allclose(fp, want, rtol=1e-6, atol=1e-6)


def test_no_interpret_mode_outside_tests():
    """Only tests may ask the Pallas interpreter for a kernel."""
    hits = []
    for base in ("ray_tracer_2_tpu", "scripts"):
        for path in (ROOT / base).rglob("*.py"):
            if "interpret=True" in path.read_text():
                hits.append(str(path))
    for name in ("bench.py", "chip_smoke.py", "__graft_entry__.py"):
        if "interpret=True" in (ROOT / name).read_text():
            hits.append(name)
    assert not hits
