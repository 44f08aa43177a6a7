"""Image IO: PFM, PNG (LDR tonemap), and minimal EXR float32 output.

Replaces the reference's imageio layer (ref: src/core/imageio.h:49-56,
lodepng, OpenEXR) and the PFM helpers in ml/pfm.py — here with zero
external dependencies (zlib + struct only).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# PFM (portable float map).  Layout matches the reference's writer
# (src/film/imagefilm.cpp pfm_write / ml/pfm.py): rows bottom-to-top,
# little-endian, scale -1.0.
# ---------------------------------------------------------------------------

def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        header, data = b"Pf", img
    elif img.ndim == 3 and img.shape[2] == 3:
        header, data = b"PF", img
    else:
        raise ValueError(f"PFM needs (h,w) or (h,w,3), got {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(data).tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        nchan = 3 if header == b"PF" else 1
        count = w * h * nchan
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(count * 4), dtype=dtype, count=count)
    img = data.reshape(h, w, nchan) if nchan == 3 else data.reshape(h, w)
    return np.flipud(img).astype(np.float32).copy()


# ---------------------------------------------------------------------------
# PNG (8-bit sRGB-ish tonemap) — replaces lodepng usage in WriteImage.
# ---------------------------------------------------------------------------

def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """img: (h, w, 3) uint8 or float in [0, inf) (gamma-encoded if float)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def _emit(f):
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))

    if hasattr(path, "write"):  # file-like (e.g. the GUI's HTTP stream)
        _emit(path)
    else:
        with open(path, "wb") as f:
            _emit(f)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG decoder: 8/16-bit gray/RGB/palette/RGBA -> (h,w,3) u8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"not a PNG: {path}")
    pos = 8
    idat = b""
    palette = None
    w = h = depth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, nch * depth // 8)
    stride = (w * nch * depth + 7) // 8
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    rp = 0
    for y in range(h):
        ft = raw[rp]
        row = np.frombuffer(raw[rp + 1 : rp + 1 + stride], np.uint8).astype(
            np.int32).copy()
        rp += 1 + stride
        if ft == 1:  # sub
            for x in range(bpp, stride):
                row[x] = (row[x] + row[x - bpp]) & 0xFF
        elif ft == 2:  # up
            row = (row + prev) & 0xFF
        elif ft == 3:  # average
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + ((a + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
        img[y] = row.astype(np.uint8)
        prev = row
    if depth == 8:
        arr = img[:, : w * nch].reshape(h, w, nch)
    elif depth == 16:
        arr = img.view(">u2")[:, : w * nch].reshape(h, w, nch)
        arr = (arr >> 8).astype(np.uint8)
    else:
        raise ValueError(f"PNG bit depth {depth} unsupported")
    if ctype == 3:
        arr = palette[arr[..., 0]]
    elif nch == 1:
        arr = np.repeat(arr, 3, axis=-1)
    elif nch == 2:
        arr = np.repeat(arr[..., :1], 3, axis=-1)
    elif nch == 4:
        arr = arr[..., :3]
    return arr


def read_tga(path: str) -> np.ndarray:
    """Minimal TGA reader (types 2/10, 24/32-bit) -> (h,w,3) u8."""
    with open(path, "rb") as f:
        data = f.read()
    idlen = data[0]
    imgtype = data[2]
    w = struct.unpack("<H", data[12:14])[0]
    h = struct.unpack("<H", data[14:16])[0]
    bpp = data[16] // 8
    desc = data[17]
    pos = 18 + idlen
    n = w * h
    if imgtype == 2:
        px = np.frombuffer(data[pos : pos + n * bpp], np.uint8).reshape(n, bpp)
    elif imgtype == 10:  # RLE
        out = np.zeros((n, bpp), np.uint8)
        i = 0
        while i < n:
            hdr = data[pos]
            pos += 1
            cnt = (hdr & 0x7F) + 1
            if hdr & 0x80:
                out[i : i + cnt] = np.frombuffer(
                    data[pos : pos + bpp], np.uint8)
                pos += bpp
            else:
                out[i : i + cnt] = np.frombuffer(
                    data[pos : pos + cnt * bpp], np.uint8).reshape(cnt, bpp)
                pos += cnt * bpp
            i += cnt
        px = out
    else:
        raise ValueError(f"TGA type {imgtype} unsupported")
    img = px[:, :3][:, ::-1].reshape(h, w, 3)  # BGR -> RGB
    if not (desc & 0x20):  # bottom-up origin
        img = np.flipud(img)
    return img.copy()


def gamma_correct(x: np.ndarray) -> np.ndarray:
    """Linear -> sRGB (ref: src/core/pbrt.h GammaCorrect)."""
    x = np.asarray(x, dtype=np.float32)
    return np.where(
        x <= 0.0031308, 12.92 * x, 1.055 * np.power(np.maximum(x, 1e-8), 1.0 / 2.4) - 0.055
    )


def write_png_tonemapped(path: str, img: np.ndarray, exposure: float = 0.0) -> None:
    """Auto-ish tonemap matching tools/cpfm semantics: scale, clamp, gamma."""
    img = np.asarray(img, dtype=np.float32) * (2.0 ** exposure)
    write_png(path, gamma_correct(np.clip(img, 0.0, 1.0)))


# ---------------------------------------------------------------------------
# EXR: minimal OpenEXR 2.0 writer/reader, single part, scanline,
# float32 RGB, no compression.  Enough for interop with the reference's
# output tooling (ref: src/core/imageio.cpp WriteEXR).
# ---------------------------------------------------------------------------

def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def write_exr(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    # channel list: sorted alphabetically B, G, R; each float (type 2)
    chans = b""
    for name in (b"B", b"G", b"R"):
        chans += name + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    chans += b"\x00"
    header = b""
    header += _exr_attr(b"channels", b"chlist", chans)
    header += _exr_attr(b"compression", b"compression", b"\x00")  # none
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 20000630))  # magic
        f.write(struct.pack("<I", 2))  # version 2, scanline
        f.write(header)
        # offset table
        base = 8 + len(header) + 8 * h
        line_bytes = 8 + w * 4 * 3
        for y in range(h):
            f.write(struct.pack("<Q", base + y * line_bytes))
        for y in range(h):
            f.write(struct.pack("<iI", y, w * 4 * 3))
            # channels in file order B, G, R
            f.write(img[y, :, 2].tobytes())
            f.write(img[y, :, 1].tobytes())
            f.write(img[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Reads single-part scanline float RGB EXR (non/zip-compressed)."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack("<I", data[:4])[0] != 20000630:
        raise ValueError("not an EXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\x00", pos)
        typ = data[pos:end].decode()
        pos = end + 1
        size = struct.unpack("<I", data[pos : pos + 4])[0]
        pos += 4
        attrs[name] = (typ, data[pos : pos + size])
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    # parse channel list
    chan_names = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        cend = cdata.index(b"\x00", cpos)
        cname = cdata[cpos:cend].decode()
        ctype = struct.unpack("<i", cdata[cend + 1 : cend + 5])[0]
        chan_names.append((cname, ctype))
        cpos = cend + 1 + 16
    nchan = len(chan_names)
    dtype_sizes = {0: 4, 1: 2, 2: 4}
    offsets = struct.unpack(f"<{h}Q", data[pos : pos + 8 * h])
    out = np.zeros((h, w, nchan), dtype=np.float32)
    lines_per_block = 1 if comp in (0, 1, 2) else 16
    for off in offsets:
        y, nbytes = struct.unpack("<iI", data[off : off + 8])
        payload = data[off + 8 : off + 8 + nbytes]
        nlines = min(lines_per_block, h - (y - y0))
        raw_size = sum(
            w * dtype_sizes[ct] for _, ct in chan_names
        ) * nlines
        if comp in (2, 3):  # ZIPS/ZIP
            raw = zlib.decompress(payload)
            # undo EXR zip predictor + interleave split
            arr = np.frombuffer(raw, dtype=np.uint8).astype(np.int64)
            # OpenEXR zip predictor: t[i] = t[i-1] + in[i] - 128 with
            # t[0] = in[0]  (the -128 applies from the SECOND byte on)
            arr = (np.cumsum(arr - 128) + 128) % 256
            arr = arr.astype(np.uint8)
            half = (len(arr) + 1) // 2
            inter = np.zeros(len(arr), dtype=np.uint8)
            inter[0::2] = arr[:half]
            inter[1::2] = arr[half : half + len(arr) - half]
            raw = inter.tobytes()
        elif comp == 0:
            raw = payload
        else:
            raise ValueError(f"unsupported EXR compression {comp}")
        assert len(raw) == raw_size, (len(raw), raw_size)
        rpos = 0
        for line in range(nlines):
            for cname, ctype in chan_names:
                nb = w * dtype_sizes[ctype]
                buf = raw[rpos : rpos + nb]
                rpos += nb
                if ctype == 2:
                    vals = np.frombuffer(buf, dtype="<f4")
                elif ctype == 1:
                    vals = np.frombuffer(buf, dtype="<f2").astype(np.float32)
                else:
                    vals = np.frombuffer(buf, dtype="<u4").astype(np.float32)
                ci = [n for n, _ in chan_names].index(cname)
                out[y - y0 + line, :, ci] = vals
    # reorder alphabetical file order -> R,G,B (dropping alpha): both
    # our own B,G,R layout and OpenEXR RgbaOutputFile's A,B,G,R
    names = [n for n, _ in chan_names]
    if names == ["B", "G", "R"]:
        out = out[:, :, ::-1]
    elif names == ["A", "B", "G", "R"]:
        out = out[:, :, 3:0:-1]
    return out.copy()
