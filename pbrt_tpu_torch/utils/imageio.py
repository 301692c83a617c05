"""Image IO: PFM (the float golden format), PNG (sRGB 8-bit), EXR, NPY.

Port of pbrt_tpu/utils/imageio.py (pbrt-v3 core/imageio.{h,cpp}):
``write_image`` dispatches on the extension (imageio.cpp:81-120); 8-bit
formats are gamma-encoded to sRGB (imageio.cpp:98 GammaCorrect), float
formats stay linear.  PFM follows imageio.cpp:124-250 (the scale's sign is
the byte order, rows bottom-up).  EXR is a minimal uncompressed FLOAT
scanline file.  PNG is written and read here with zlib alone (8-bit,
non-interlaced), so the port needs no image package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_image(path: str, rgb: np.ndarray):
    rgb = np.asarray(rgb, np.float32)
    if path.endswith(".pfm"):
        write_pfm(path, rgb)
    elif path.endswith(".png"):
        write_png(path, rgb)
    elif path.endswith(".exr"):
        write_exr(path, rgb)
    elif path.endswith(".npy"):
        np.save(path, rgb)
    else:
        raise ValueError(f"unsupported image format: {path}")


def read_image(path: str) -> np.ndarray:
    if path.endswith(".pfm"):
        return read_pfm(path)
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".png"):
        return _srgb_to_linear(read_png(path)[..., :3].astype(np.float32) / 255.0)
    if path.endswith(".exr"):
        return read_exr(path)
    raise ValueError(f"unsupported image format: {path}")


def _linear_to_srgb(v):
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.power(np.maximum(v, 1e-10), 1 / 2.4) - 0.055)


def _srgb_to_linear(v):
    return np.where(v <= 0.04045, v / 12.92, np.power((v + 0.055) / 1.055, 2.4))


# ---------------------------------------------------------------------------
# PFM (imageio.cpp:124-250)
# ---------------------------------------------------------------------------

def write_pfm(path: str, rgb: np.ndarray):
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.000000\n")  # negative = little endian
        f.write(np.flipud(rgb.astype("<f4")).tobytes())  # rows bottom-up


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        nchan = 3 if magic == b"PF" else 1
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * nchan * 4), dt)
        return np.flipud(data.reshape(h, w, nchan)).astype(np.float32)


# ---------------------------------------------------------------------------
# PNG: 8-bit, non-interlaced
# ---------------------------------------------------------------------------

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray):
    """sRGB-encoded 8-bit RGB."""
    srgb = np.clip(_linear_to_srgb(np.clip(rgb, 0, 1)) * 255.0 + 0.5, 0, 255)
    px = srgb.astype(np.uint8)[..., :3]
    h, w = px.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, 3 * w)], 1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """[H, W, C] uint8 of an 8-bit, non-interlaced gray, RGB or RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    chans = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * chans)
    out = np.zeros((h, w * chans), np.int32)
    prev = np.zeros(w * chans, np.int32)
    for y in range(h):
        ftype, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 1:  # sub: a running sum per channel
            cur = np.cumsum(row.reshape(w, chans), 0).reshape(-1) & 0xFF
        elif ftype == 2:  # up
            cur = (row + prev) & 0xFF
        elif ftype in (3, 4):  # average, paeth: byte by byte
            cur = np.zeros_like(row)
            for x in range(w * chans):
                a = cur[x - chans] if x >= chans else 0
                b = prev[x]
                c = prev[x - chans] if x >= chans else 0
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: bad PNG filter {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, chans).astype(np.uint8)


# ---------------------------------------------------------------------------
# EXR: single-part scanline, FLOAT, uncompressed
# ---------------------------------------------------------------------------

def _exr_attr(name: bytes, atype: bytes, value: bytes) -> bytes:
    return name + b"\0" + atype + b"\0" + struct.pack("<i", len(value)) + value


def write_exr(path: str, rgb: np.ndarray):
    """Uncompressed FLOAT scanline EXR with B, G, R channels."""
    h, w = rgb.shape[:2]
    rgb = np.asarray(rgb, "<f4")
    channels = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, as the format requires
        channels += name + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)  # FLOAT
    channels += b"\0"
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += _exr_attr(b"channels", b"chlist", channels)
    header += _exr_attr(b"compression", b"compression", b"\0")  # none
    header += _exr_attr(b"dataWindow", b"box2i", dw)
    header += _exr_attr(b"displayWindow", b"box2i", dw)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\0")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    first_data = len(magic) + len(header) + 8 * h
    offsets = b"".join(struct.pack("<q", first_data + y * (8 + w * 12))
                       for y in range(h))
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(offsets)
        for y in range(h):
            row = rgb[y]
            payload = row[:, 2].tobytes() + row[:, 1].tobytes() + row[:, 0].tobytes()
            f.write(struct.pack("<ii", y, len(payload)))
            f.write(payload)


def read_exr(path: str) -> np.ndarray:
    """Reader for the files write_exr produces (uncompressed FLOAT)."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack("<i", data[:4])[0] != 20000630:
        raise ValueError("not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\0", pos)
        atype = data[pos:e].decode()
        pos = e + 1
        (alen,) = struct.unpack("<i", data[pos:pos + 4])
        pos += 4
        attrs[name] = (atype, data[pos:pos + alen])
        pos += alen
    pos += 1
    if attrs["compression"][1] != b"\0":
        raise ValueError("only uncompressed EXR is supported by this reader")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    pos += 8 * h  # offset table
    out = np.zeros((h, w, 3), np.float32)
    for _ in range(h):
        y, size = struct.unpack("<ii", data[pos:pos + 8])
        pos += 8
        row = np.frombuffer(data[pos:pos + size], "<f4").reshape(3, w)
        pos += size
        out[y - y0, :, 2] = row[0]  # B
        out[y - y0, :, 1] = row[1]  # G
        out[y - y0, :, 0] = row[2]  # R
    return out
