"""In-kernel texture sampling.

XLA exposes no texture samplers — the reference's repeat-addressed bilinear
``textureSampleLevel`` (ray_tracer.rs:197-205, ray_tracer.wgsl:455) becomes
explicit wrap addressing + a 4-tap gather from the texel atlas.

The atlas default is u8 RGBA words packed as bilinear QUADS — texel plus
its wrapped x/y/xy neighbors in one 512-byte row (32 texels/row,
assets/textures.py pack_texels_u8_quads) — so a bilinear sample costs ONE
row gather. The lineage, each step measured before the H100 port: flat
(X, 4) f32 -> flat u8 rows (4 gathers) -> (y, y+1) PAIR rows (2 gathers)
-> quads (1 gather; pairs kept under RT2_TEX_LAYOUT=pairs, queued for an
H100 A/B). The per-lane column
extract is a one-hot multiply + lane reduction done on exact 16-bit
halves (u32 payloads don't fit f32), and the u8 unpack is integer shifts
— both ride under the gather latency. Texel rows are fetched with a raw
take, NEVER the one-hot matmul fast path: the bitcast payloads can view as
signaling NaNs, which a matmul quietizes (blue-bit-6 corruption).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

def _texel_rows(texels, row_idx):
    """Texel-row fetch: ALWAYS a gather, never the one-hot matmul path.
    Texel rows are bitcast u8-packed u32 payloads whose f32 views can be
    signaling NaNs (any opaque texel with blue >= 128); the one-hot matmul
    QUIETIZES them (x*1.0 flips the mantissa MSB), silently corrupting the
    blue channel's bit 6 for small (<= 2048-row) atlases. A take moves raw
    bits. Regression: tests/test_assets.py texel-payload tests."""
    return jnp.take(texels, row_idx, axis=0)


def _tap(texels, flat_idx):
    """Fetch texel ``flat_idx`` (B,) from the packed atlas -> (B, 4) f32."""
    row = _texel_rows(texels, jax.lax.shift_right_logical(flat_idx, 7))
    u = jax.lax.bitcast_convert_type(row, jnp.uint32)
    lane = jnp.arange(128, dtype=jnp.int32)[None, :]
    oh = (lane == (flat_idx & 127)[:, None]).astype(jnp.float32)
    # 16-bit halves are exact in f32; the one-hot sum is an exact select
    lo = jnp.sum((u & 0xFFFF).astype(jnp.float32) * oh, axis=1)
    hi = jnp.sum((u >> 16).astype(jnp.float32) * oh, axis=1)
    w = lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16)
    return jnp.stack([(w & 0xFF).astype(jnp.float32),
                      ((w >> 8) & 0xFF).astype(jnp.float32),
                      ((w >> 16) & 0xFF).astype(jnp.float32),
                      ((w >> 24) & 0xFF).astype(jnp.float32)],
                     axis=1) / 255.0


def _unpack_rgba(w):
    return jnp.stack([(w & 0xFF).astype(jnp.float32),
                      ((w >> 8) & 0xFF).astype(jnp.float32),
                      ((w >> 16) & 0xFF).astype(jnp.float32),
                      ((w >> 24) & 0xFF).astype(jnp.float32)],
                     axis=1) / 255.0


def _tap_pair(texels, flat_idx):
    """Fetch texel ``flat_idx`` AND its wrapped y-neighbor from the PAIRED
    atlas (pack_texels_u8_pairs) with ONE row gather -> two (B, 4) f32."""
    row = _texel_rows(texels, jax.lax.shift_right_logical(flat_idx, 6))
    u = jax.lax.bitcast_convert_type(row, jnp.uint32)
    lane = jnp.arange(64, dtype=jnp.int32)[None, :]
    oh = (lane == (flat_idx & 63)[:, None]).astype(jnp.float32)
    # 16-bit halves are exact in f32; the one-hot sum is an exact select
    lo0 = jnp.sum((u[:, :64] & 0xFFFF).astype(jnp.float32) * oh, axis=1)
    hi0 = jnp.sum((u[:, :64] >> 16).astype(jnp.float32) * oh, axis=1)
    lo1 = jnp.sum((u[:, 64:] & 0xFFFF).astype(jnp.float32) * oh, axis=1)
    hi1 = jnp.sum((u[:, 64:] >> 16).astype(jnp.float32) * oh, axis=1)
    w0 = lo0.astype(jnp.uint32) | (hi0.astype(jnp.uint32) << 16)
    w1 = lo1.astype(jnp.uint32) | (hi1.astype(jnp.uint32) << 16)
    return _unpack_rgba(w0), _unpack_rgba(w1)


def _tap_quad(texels, flat_idx):
    """Fetch texel ``flat_idx`` plus its wrapped x/y/xy neighbors from the
    QUAD atlas (pack_texels_u8_quads) with ONE row gather ->
    (c00, c01, c10, c11), each (B, 4) f32."""
    row = _texel_rows(texels, jax.lax.shift_right_logical(flat_idx, 5))
    u = jax.lax.bitcast_convert_type(row, jnp.uint32)
    lane = jnp.arange(32, dtype=jnp.int32)[None, :]
    oh = (lane == (flat_idx & 31)[:, None]).astype(jnp.float32)
    out = []
    for b in range(4):
        blk = u[:, 32 * b:32 * (b + 1)]
        # 16-bit halves are exact in f32; the one-hot sum is an exact select
        lo = jnp.sum((blk & 0xFFFF).astype(jnp.float32) * oh, axis=1)
        hi = jnp.sum((blk >> 16).astype(jnp.float32) * oh, axis=1)
        out.append(_unpack_rgba(
            lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16)))
    c00, c01, c10, c11 = out
    return c00, c01, c10, c11


def sample_bilinear_quads(texels, tex_meta, slot, uv):
    """Bilinear sample with repeat wrap — ONE row gather (quad atlas).

    Same metadata/addressing/blend expressions as ``sample_bilinear``; the
    wrapped x/y neighbors are baked into the quad row at pack time, so no
    second texel index is computed. Bit-equal to the pair layout (same u8
    words, same f32 blend order)."""
    from ray_tracer_2_tpu.kernels.gatherlib import fetch_rows

    slot = jnp.maximum(slot, 0)
    meta = fetch_rows(tex_meta, slot)
    off = meta[:, 0].astype(jnp.int32)
    h = meta[:, 1].astype(jnp.int32)
    w = meta[:, 2].astype(jnp.int32)
    hf = meta[:, 1]
    wf = meta[:, 2]

    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    xf = u * wf - 0.5
    yf = v * hf - 0.5
    x0 = jnp.floor(xf)
    y0 = jnp.floor(yf)
    tx = (xf - x0)[..., None]
    ty = (yf - y0)[..., None]

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), n)

    x0w = wrap(x0, w)
    y0w = wrap(y0, h)

    c00, c01, c10, c11 = _tap_quad(texels, off + y0w * w + x0w)
    top = c00 * (1.0 - tx) + c01 * tx
    bot = c10 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def sample_bilinear(texels, tex_meta, slot, uv):
    """Bilinear sample with repeat wrap — TWO row gathers, not four.

    texels: (R, 128) f32 PAIRED u8 atlas rows (pack_texels_u8_pairs: col
    t & 63 is texel t, col 64 + (t & 63) is its wrapped y+1 neighbor);
    tex_meta: (64, 4) [offset, h, w, pad] rows (one gather resolves all
    slot metadata); slot: (B,) int32 (clamped to >= 0 by the caller's
    mask); uv: (B, 2). Returns (B, 4). Output is bit-equal to the flat
    4-tap layout (same u8 words, same blend arithmetic)."""
    from ray_tracer_2_tpu.kernels.gatherlib import fetch_rows

    slot = jnp.maximum(slot, 0)
    meta = fetch_rows(tex_meta, slot)
    off = meta[:, 0].astype(jnp.int32)
    h = meta[:, 1].astype(jnp.int32)
    w = meta[:, 2].astype(jnp.int32)
    hf = meta[:, 1]
    wf = meta[:, 2]

    # Repeat wrap of the sample position, then texel-centered bilinear.
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    xf = u * wf - 0.5
    yf = v * hf - 0.5
    x0 = jnp.floor(xf)
    y0 = jnp.floor(yf)
    tx = (xf - x0)[..., None]
    ty = (yf - y0)[..., None]

    def wrap(i, n):
        return jnp.mod(i.astype(jnp.int32), n)

    x0w, x1w = wrap(x0, w), wrap(x0 + 1, w)
    y0w = wrap(y0, h)

    c00, c10 = _tap_pair(texels, off + y0w * w + x0w)
    c01, c11 = _tap_pair(texels, off + y0w * w + x1w)
    top = c00 * (1.0 - tx) + c01 * tx
    bot = c10 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def sample_texture(scene, slot, uv):
    """Layout-dispatching bilinear sample: scene.tex_quads is a STATIC
    pytree field, so the branch resolves at trace time."""
    fn = sample_bilinear_quads if scene.tex_quads else sample_bilinear
    return fn(scene.tex_texels, scene.tex_meta, slot, uv)
