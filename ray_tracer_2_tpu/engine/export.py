"""Framebuffer export (ref: App::save_render_to_file, app.rs:341-465).

The reference reads the Rgba32Float texture back, applies gamma 1/2.2 and
writes a PNG whose net orientation is a vertical flip of the raw buffer
(rows are written x-reversed, then flip_horizontal + flip_vertical —
app.rs:408-463). Our framebuffer uses the same convention (row 0 = bottom of
the view, because pixel v=0 maps to -plane_height/2 along camera up), so
export applies the same vertical flip.

Fixed relative to the reference: alpha is not gamma-encoded (app.rs:445 bug)
and the output path is an argument, not a hardcoded Windows path (app.rs:218).

PNG files are written and read with the standard library alone (zlib +
struct): 8-bit RGB or RGBA, non-interlaced.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}   # channels -> PNG colour type (RGB, RGBA)


def framebuffer_to_srgb(fb: np.ndarray, flip_vertical: bool = True) -> np.ndarray:
    """(H, W, 4) float32 linear → (H, W, 3) uint8 with gamma 1/2.2
    (app.rs:442-445) and the export pipeline's net vertical flip
    (app.rs:408-463)."""
    rgb = np.clip(np.asarray(fb)[..., :3], 0.0, 1.0)
    if flip_vertical:
        rgb = rgb[::-1]
    return (rgb ** (1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3|4) uint8 image as a PNG (filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                         axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Decode an 8-bit RGB/RGBA non-interlaced PNG to (H, W, 3|4) uint8.
    Raises ValueError on anything else or on a corrupt file."""
    data = open(path, "rb").read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, ctype, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: unsupported PNG format {header}")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 1 or kind == 3 or kind == 4:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                cc = prev[x - channels] if x >= channels else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else cc)
                cur[x] = (line[x] + pred) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 0:
            cur = line
        else:
            raise ValueError(f"{path}: bad filter type {kind}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, channels)


def save_png(fb: np.ndarray, path) -> None:
    """Framebuffer (H, W, 4) float32 linear → sRGB PNG at ``path``."""
    write_png(path, framebuffer_to_srgb(fb))
