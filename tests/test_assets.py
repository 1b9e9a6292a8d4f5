"""OBJ/MTL loading parity against the checked-in reference assets
(SURVEY.md §4: parser vs CornellBox-Original.mtl, dice.mtl)."""
import numpy as np
import pytest

from tests.conftest import require_asset


def test_cornell_parse(assets):
    require_asset(assets, "CornellBox-Original.obj")
    parts = assets.load_model("CornellBox-Original.obj", use_mtl=True)
    labels = [lbl for _, _, lbl in parts]
    total_tris = sum(m.triangle_count() for m, _, _ in parts)
    assert total_tris == 32  # 5 walls*2 + 2 boxes*(5 quads=10) + light*2
    # light material: Ke 17 → strength 34 after the reference's ×2
    light = [rec for _, rec, lbl in parts if lbl == "light"][0]
    # Ke 17 12 4 → strength = 17, ×2 = 34; color = Ke/17
    assert abs(light.emission_strength - 34.0) < 1e-5
    np.testing.assert_allclose(light.emission_color[:3],
                               [1.0, 12.0 / 17.0, 4.0 / 17.0], atol=1e-6)
    # walls are diffuse with Ks=0 → specular 0
    wall = [rec for _, rec, lbl in parts if lbl == "leftWall"][0]
    assert wall.specular == 0.0
    # Ns 10 → smoothness sqrt(0.1)
    assert abs(wall.smoothness - 0.1 ** 0.5) < 1e-5


def test_dice_parse_textured(assets):
    require_asset(assets, "dice.obj")
    parts = assets.load_model("dice.obj", use_mtl=True)
    mesh, rec, _ = parts[0]
    assert rec.flag == 2  # TEXTURE (map_Kd dice.png)
    assert rec.diffuse_index >= 0
    assert mesh.uvs.shape[1] == 2 and np.abs(mesh.uvs).max() > 0
    # normals present & unit
    norms = np.linalg.norm(mesh.normals, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_mtl_conversion_rules(tmp_path):
    from ray_tracer_2_tpu.assets.obj import load_mtl
    from ray_tracer_2_tpu.assets.manager import material_from_mtl
    mtl = tmp_path / "t.mtl"
    mtl.write_text("""
newmtl glassy
Ns 400.0
Ni 1.52
illum 4
Kd 0.2 0.3 0.4
Ks 0.5 0.6 0.7
newmtl lamp
Ke 2.0 1.0 0.5
""")
    mats = load_mtl(mtl)
    g = material_from_mtl(mats["glassy"], -1, -1)
    assert g.flag == 1  # GLASS via illum 4
    assert abs(g.ior - 1.52) < 1e-6
    assert g.smoothness == 1.0  # sqrt(4) clamped to 1
    assert abs(g.specular - 0.7) < 1e-6
    lamp = material_from_mtl(mats["lamp"], -1, -1)
    assert abs(lamp.emission_strength - 4.0) < 1e-6  # max(Ke)*2
    np.testing.assert_allclose(lamp.emission_color[:3], [1.0, 0.5, 0.25])


def test_negative_indices(tmp_path):
    from ray_tracer_2_tpu.assets.obj import load_obj
    p = tmp_path / "neg.obj"
    p.write_text("""
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
v 0 0 1
v 1 0 1
v 0 1 1
f -3 -2 -1
""")
    models, _ = load_obj(p)
    soup = np.concatenate([m.positions for m in models])
    assert soup.shape == (6, 3)
    np.testing.assert_allclose(soup[3], [0, 0, 1])


def test_texture_flip(assets, tmp_path):
    """Images are flipped horizontally at load (asset.rs:77)."""
    from PIL import Image
    from ray_tracer_2_tpu.assets.textures import load_image_rgba
    img = np.zeros((1, 2, 3), np.uint8)
    img[0, 0] = [255, 0, 0]
    p = tmp_path / "t.png"
    Image.fromarray(img).save(p)
    arr = load_image_rgba(p)
    assert arr[0, 1, 0] == 1.0 and arr[0, 0, 0] == 0.0


def test_quality_atlas_roundtrip():
    from ray_tracer_2_tpu.assets.textures import TextureAtlas
    img = np.random.default_rng(0).uniform(size=(4, 6, 4)).astype(np.float32)
    atlas = TextureAtlas.from_images([img])
    assert atlas.heights[0] == 4 and atlas.widths[0] == 6
    got = atlas.texels[atlas.offsets[0]:atlas.offsets[0] + 24].reshape(4, 6, 4)
    np.testing.assert_allclose(got, img)


def test_dragon_80k_synthesis(assets):
    require_asset(assets, "dragon.obj")
    from ray_tracer_2_tpu.assets.procedural import densify_to
    parts = assets.load_model("dragon.obj", use_mtl=False)
    mesh, _, _ = parts[0]
    idx = mesh.indices.reshape(-1, 3)
    v, n, uv = mesh.positions[idx], mesh.normals[idx], mesh.uvs[idx]
    v2, n2, uv2 = densify_to(v, n, uv, 20000)
    assert 20000 <= len(v2) <= 20002
    # surface identical: total area preserved
    def area(t):
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=-1).sum()
    assert abs(area(v2) - area(v)) / area(v) < 1e-4


def test_native_obj_parser_matches_python(assets):
    """The C++ tokenizer (assets/native) must reproduce the Python parse
    bit-for-bit on the reference's real assets."""
    import os
    import time
    import numpy as np
    from tests.conftest import require_asset
    from ray_tracer_2_tpu.assets import obj as objmod
    from ray_tracer_2_tpu.assets.native import parse_obj_native

    for rel in ("CornellBox-Original.obj", "dice.obj", "dragon.obj"):
        path = require_asset(assets, rel)
        native = parse_obj_native(path)
        if native is None:
            import pytest
            pytest.skip("native OBJ parser unavailable")
        pos_n, uv_n, nrm_n, groups_n, _libs = native
        pos_p, uv_p, nrm_p, groups_p, _mats = objmod._parse_obj_python(path)
        np.testing.assert_array_equal(pos_n, pos_p)
        np.testing.assert_array_equal(uv_n, uv_p)
        np.testing.assert_array_equal(nrm_n, nrm_p)
        assert list(groups_n.keys()) == list(groups_p.keys())
        for k in groups_p:
            np.testing.assert_array_equal(groups_n[k], groups_p[k])

    # end-to-end: models via load_obj (native) == via the python parse
    path = require_asset(assets, "CornellBox-Original.obj")
    models_native, mats_native = objmod.load_obj(path)
    os.environ["RT2_NATIVE_OBJ"] = "0"
    try:
        models_py, mats_py = objmod.load_obj(path)
    finally:
        os.environ.pop("RT2_NATIVE_OBJ")
    assert len(models_native) == len(models_py)
    assert set(mats_native) == set(mats_py)
    for a, b in zip(models_native, models_py):
        assert (a.name, a.material) == (b.name, b.material)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.normals, b.normals)
        np.testing.assert_array_equal(a.uvs, b.uvs)


def test_loader_thread_survives_failed_scene():
    """A scene whose constructor raises (EMPTY preserves the reference's
    todo!(), scene.rs:1012) must not kill the loader thread: the failure
    is logged, load_blocking raises, and the NEXT request still loads
    (SURVEY §5.3 failure handling)."""
    import pytest

    from ray_tracer_2_tpu.scene.manager import SceneManager
    from ray_tracer_2_tpu.scene.scenes import SceneName

    mgr = SceneManager()
    try:
        with pytest.raises(RuntimeError, match="scene load failed"):
            mgr.load_blocking(SceneName.EMPTY)
        scene = mgr.load_blocking(SceneName.METAL)
        assert scene is not None and mgr.scene is scene
    finally:
        mgr.shutdown()


def test_texel_quad_layout_matches_pairs():
    """The quad atlas (one gather per bilinear) must sample bit-equal to
    the paired atlas on random uvs across several texture shapes,
    including wrap rows/cols."""
    import numpy as np
    import jax.numpy as jnp

    from ray_tracer_2_tpu.assets.textures import (
        pack_texels_u8_pairs, pack_texels_u8_quads)
    from ray_tracer_2_tpu.kernels.texture import (
        sample_bilinear, sample_bilinear_quads)

    rng = np.random.default_rng(11)
    shapes = [(8, 8), (5, 7), (16, 3)]
    texels, offs, hs, ws = [], [], [], []
    off = 0
    for h, w in shapes:
        texels.append(rng.random((h * w, 4), np.float32))
        offs.append(off)
        hs.append(h)
        ws.append(w)
        off += h * w
    texels = np.concatenate(texels)
    offs, hs, ws = (np.asarray(a, np.int32) for a in (offs, hs, ws))
    pairs = jnp.asarray(pack_texels_u8_pairs(texels, offs, hs, ws))
    quads = jnp.asarray(pack_texels_u8_quads(texels, offs, hs, ws))
    meta = jnp.asarray(
        np.stack([offs, hs, ws, np.zeros_like(offs)], 1).astype(np.float32))

    B = 256
    slot = jnp.asarray(rng.integers(0, len(shapes), B).astype(np.int32))
    uv = jnp.asarray(rng.uniform(-1.5, 2.5, (B, 2)).astype(np.float32))
    a = np.asarray(sample_bilinear(pairs, meta, slot, uv))
    b = np.asarray(sample_bilinear_quads(quads, meta, slot, uv))
    np.testing.assert_array_equal(a, b)


def test_texel_taps_preserve_nan_payload_bits():
    """Texel words are bitcast u8 payloads; opaque texels with blue >= 128
    view as signaling NaNs in f32. The tap fetch must move RAW BITS — the
    one-hot matmul path quietizes NaNs (corrupting blue bit 6), which is why
    texel fetches never take gatherlib's small-table fast path."""
    import numpy as np
    import jax.numpy as jnp

    from ray_tracer_2_tpu.assets.textures import (
        pack_texels_u8_pairs, pack_texels_u8_quads)
    from ray_tracer_2_tpu.kernels.texture import _tap_pair, _tap_quad

    # one tiny texture, every texel opaque with blue=128 (snan pattern)
    h = w = 8
    texels = np.tile(np.array([[10 / 255, 20 / 255, 128 / 255, 1.0]],
                              np.float32), (h * w, 1))
    offs = np.array([0], np.int32)
    hs = np.array([h], np.int32)
    ws = np.array([w], np.int32)
    pairs = jnp.asarray(pack_texels_u8_pairs(texels, offs, hs, ws))
    quads = jnp.asarray(pack_texels_u8_quads(texels, offs, hs, ws))
    idx = jnp.arange(h * w, dtype=jnp.int32)
    expect = np.tile(texels[:1], (h * w, 1))
    for got in (*_tap_pair(pairs, idx), *_tap_quad(quads, idx)):
        np.testing.assert_allclose(np.asarray(got), expect, atol=0.5 / 255)


def test_texel_budget_downsampling(monkeypatch):
    """RT2_TEX_BUDGET_MB shrinks oversized texture sets at scene build
    (area-preserving BOX downscale, u8-grid preserved); default-off keeps
    the exact full-resolution path (ray_tracer.wgsl:455-459 parity)."""
    import numpy as np
    from ray_tracer_2_tpu.assets.textures import downsample_images_to_budget

    c0, c1 = 128.0 / 255.0, 64.0 / 255.0   # u8-grid-aligned constants
    imgs = [np.full((64, 32, 4), c0, np.float32),
            None,
            np.full((128, 128, 4), c1, np.float32)]
    out = downsample_images_to_budget(imgs, (64 * 32 + 128 * 128) // 4)
    assert out[1] is None
    total = sum(im.shape[0] * im.shape[1] for im in out if im is not None)
    assert total <= (64 * 32 + 128 * 128) // 4 * 1.1
    # constant images stay exactly constant under area averaging
    assert np.allclose(out[0], c0) and np.allclose(out[2], c1)
    # on the u8 grid (atlas quantization is lossless afterwards)
    for im in (out[0], out[2]):
        q = im * 255.0
        assert np.abs(q - q.round()).max() < 1e-3
    # under-budget sets pass through untouched (identity objects)
    same = downsample_images_to_budget(imgs, 10 ** 9)
    assert same[0] is imgs[0] and same[2] is imgs[2]
