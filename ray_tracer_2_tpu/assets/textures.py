"""Texture loading + device atlas.

The reference binds a dense 64-slot ``binding_array`` of textures with a
repeat/linear sampler (ray_tracer.rs:139-205). XLA has no texture-unit path,
so textures live in one flat texel buffer with per-slot (offset, height, width)
tables, and the kernel does its own wrap addressing + bilinear filtering
(kernels/texture.py). Images are flipped horizontally at load — a reference
behavior scenes depend on (asset.rs:77).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ray_tracer_2_tpu.config import MAX_TEXTURES


def _pil_image():
    """PIL's Image module, imported on first use: decoding texture files
    and resizing them are the only host steps that need Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding or resizing texture images needs the "
                          "Pillow package (PIL), which is not installed"
                          ) from e
    return Image


def load_image_rgba(path) -> np.ndarray:
    """Decode to (H, W, 4) float32 in [0,1], flipped horizontally
    (asset.rs:77)."""
    with _pil_image().open(path) as im:
        im = im.convert("RGBA")
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return arr[:, ::-1, :].copy()  # horizontal flip


@dataclasses.dataclass
class TextureAtlas:
    """Host-side staging for the flat texel buffer; ``as_arrays`` yields the
    device tables."""

    texels: np.ndarray    # (N_texels, 4) float32
    offsets: np.ndarray   # (MAX_TEXTURES,) int32 — start texel per slot
    heights: np.ndarray   # (MAX_TEXTURES,) int32
    widths: np.ndarray    # (MAX_TEXTURES,) int32

    @staticmethod
    def from_images(images: list[np.ndarray | None]) -> "TextureAtlas":
        """Build from per-slot images (None ⇒ 1x1 black, matching the dummy
        fill of ray_tracer.rs:276-296)."""
        assert len(images) <= MAX_TEXTURES
        offsets = np.zeros(MAX_TEXTURES, np.int32)
        heights = np.ones(MAX_TEXTURES, np.int32)
        widths = np.ones(MAX_TEXTURES, np.int32)
        chunks = []
        cursor = 0
        for slot in range(MAX_TEXTURES):
            img = images[slot] if slot < len(images) else None
            if img is None:
                img = np.zeros((1, 1, 4), np.float32)
            h, w = img.shape[:2]
            offsets[slot] = cursor
            heights[slot] = h
            widths[slot] = w
            chunks.append(img.reshape(-1, 4).astype(np.float32))
            cursor += h * w
        return TextureAtlas(np.concatenate(chunks, axis=0), offsets, heights, widths)

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas.from_images([])


def downsample_images_to_budget(images: list, budget_texels: int) -> list:
    """Uniformly downscale oversized texture sets to ``budget_texels`` total
    (area-preserving ratio, PIL BOX filter = exact area average; output
    stays on the u8/255 grid).

    Why: dependent texel-row gathers slow down once the table outgrows the
    caches (sponza's quad atlas is 168 MB); a 1-2M texel budget (16-32 MB
    quad rows) keeps it small. The budget was chosen before the H100 port
    and is queued for an H100 A/B (ROADMAP R7). The reference samples full-resolution textures in-kernel
    (ray_tracer.wgsl:455-459), so this is OFF by default and scenes keep the
    exact path unless RT2_TEX_BUDGET_MB is set (render_scene._tex_budget).
    Images at-or-under budget pass through untouched."""
    total = sum(int(im.shape[0]) * int(im.shape[1])
                for im in images if im is not None)
    if total <= budget_texels:
        return images
    Image = _pil_image()

    r = (budget_texels / total) ** 0.5
    out = []
    for im in images:
        if im is None or im.shape[0] * im.shape[1] <= 16:
            out.append(im)
            continue
        h, w = im.shape[:2]
        nh = max(1, int(round(h * r)))
        nw = max(1, int(round(w * r)))
        if (nh, nw) == (h, w):
            out.append(im)
            continue
        u8 = (np.clip(im, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        # per-channel resize: PIL premultiplies alpha for RGBA resizes,
        # which corrupts RGB by a bit even at constant alpha
        chans = [np.asarray(Image.fromarray(u8[..., c], "L")
                            .resize((nw, nh), Image.BOX), dtype=np.float32)
                 for c in range(4)]
        out.append(np.stack(chans, axis=-1) / 255.0)
    return out


def _quantize_u8(texels: np.ndarray) -> np.ndarray:
    u8 = (np.clip(texels, 0.0, 1.0) * 255.0).round().astype(np.uint32)
    err = np.abs(np.clip(texels, 0.0, 1.0) * 255.0 - u8)
    if err.size and float(err.max()) > 1e-3:
        import warnings
        warnings.warn(
            "texel pack: input texels are not on the u8/255 grid "
            f"(max quantization error {err.max() / 255.0:.4g}) — HDR/float "
            "textures degrade silently in the u8 atlas", stacklevel=3)
    return u8


def pack_texels_u8_pairs(texels: np.ndarray, offsets: np.ndarray,
                         heights: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """(X, 4) f32 texels -> (ceil(X/64), 128) f32 rows of PAIRED u8 RGBA
    words: texel t = (x, y) of its slot lives at row t >> 6; column t & 63
    holds texel (x, y) and column 64 + (t & 63) holds texel (x, (y+1) %% h)
    of the same slot.

    A bilinear tap needs (x0, y0) (x0, y1) (x1, y0) (x1, y1); with the y
    pair baked into the row, the 4 per-tap gathers of the flat layout
    become 2. Storage doubles — each texel also appears as the y-neighbor
    of the row above — which is cheap next to halving the gather count.
    Values are the identical u8 words, so sampling is bit-equal
    to the flat layout's."""
    x = texels.shape[0]
    u8 = _quantize_u8(texels)
    words = (u8[:, 0] | (u8[:, 1] << 8) | (u8[:, 2] << 16)
             | (u8[:, 3] << 24)).astype(np.uint32)
    hi = np.empty_like(words)
    for off, h, w in zip(offsets, heights, widths):
        off, h, w = int(off), int(h), int(w)
        if off >= x:
            continue
        blk = words[off:off + h * w].reshape(h, w)
        hi[off:off + h * w] = np.roll(blk, -1, axis=0).reshape(-1)
    xp = -(-max(x, 1) // 64) * 64
    lo_p = np.concatenate([words, np.zeros(xp - x, np.uint32)])
    hi_p = np.concatenate([hi, np.zeros(xp - x, np.uint32)])
    rows = np.concatenate([lo_p.reshape(-1, 64), hi_p.reshape(-1, 64)],
                          axis=1)
    return rows.view(np.float32)


def pack_texels_u8_quads(texels: np.ndarray, offsets: np.ndarray,
                         heights: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """(X, 4) f32 texels -> (ceil(X/32), 128) f32 rows of bilinear QUADS:
    texel t = (x, y) of its slot lives at row t >> 5, column block t & 31:

      col       t & 31   word (x, y)
      col  32 + t & 31   word ((x+1) %% w, y)       x-neighbor, wrap baked
      col  64 + t & 31   word (x, (y+1) %% h)       y-neighbor
      col  96 + t & 31   word ((x+1) %% w, (y+1) %% h)

    One row gather yields ALL FOUR bilinear corners — the tap count drops
    from the pair layout's 2 to 1. Storage doubles again vs pairs (4 words
    per texel); rows, not bytes, are the currency. Values are the identical u8 words and
    the sampler uses the identical blend expressions, so sampling stays
    bit-equal to the flat and paired layouts."""
    x = texels.shape[0]
    u8 = _quantize_u8(texels)
    words = (u8[:, 0] | (u8[:, 1] << 8) | (u8[:, 2] << 16)
             | (u8[:, 3] << 24)).astype(np.uint32)
    x1 = words.copy()
    y1 = words.copy()
    xy = words.copy()
    for off, h, w in zip(offsets, heights, widths):
        off, h, w = int(off), int(h), int(w)
        if off >= x:
            continue
        blk = words[off:off + h * w].reshape(h, w)
        x1[off:off + h * w] = np.roll(blk, -1, axis=1).reshape(-1)
        y1[off:off + h * w] = np.roll(blk, -1, axis=0).reshape(-1)
        xy[off:off + h * w] = np.roll(blk, (-1, -1), axis=(0, 1)).reshape(-1)
    xp = -(-max(x, 1) // 32) * 32
    pad = np.zeros(xp - x, np.uint32)
    planes = [np.concatenate([p, pad]).reshape(-1, 32)
              for p in (words, x1, y1, xy)]
    return np.concatenate(planes, axis=1).view(np.float32)


def pack_texels_u8(texels: np.ndarray) -> np.ndarray:
    """(X, 4) f32 texels -> (ceil(X/128), 128) f32 rows of u8 RGBA words.

    Texel t lives in row t >> 7, column t & 127, packed R | G<<8 | B<<16 |
    A<<24 (values quantized to u8 — lossless for PNG-decoded textures,
    which arrive as u8/255, and reference-faithful for procedural ones:
    the reference uploads Rgba8 textures, asset.rs:77). 512-byte rows
    gather fewer granules than the 16-byte (X, 4) layout."""
    x = texels.shape[0]
    u8 = _quantize_u8(texels)
    words = (u8[:, 0] | (u8[:, 1] << 8) | (u8[:, 2] << 16)
             | (u8[:, 3] << 24)).astype(np.uint32)
    xp = -(-max(x, 1) // 128) * 128
    words = np.concatenate([words, np.zeros(xp - x, np.uint32)])
    return words.view(np.float32).reshape(-1, 128)
