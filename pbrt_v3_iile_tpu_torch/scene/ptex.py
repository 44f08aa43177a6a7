"""Ptex per-face textures: .ptx container IO + per-face atlas build.

A copy of the JAX package's ``scene/ptex.py`` (numpy, struct and zlib
only), so that the port imports nothing of that package.

Replaces the reference's ptex plugin (ref: src/textures/ptex.{h,cpp},
which wraps the external Ptex library — vendored as an EMPTY submodule
in this checkout, src/ext/ptex/) with a dependency-free implementation:

- `read_ptx`/`write_ptx` implement the Ptex v1 container layout (magic
  'Ptex', version, mesh/data type words, zlib-deflated face-info /
  const-data / level-0 texel blocks).  With no Ptex assets or library
  source available in this environment, conformance is validated by
  round-trip and by graceful failure: files whose layout deviates raise
  and the texture degrades to its constant fallback (the same
  degradation story the reference uses for a missing ptex file).
- The TPU-side representation is a flat per-face texel pool + per-face
  (offset, res_u, res_v) tables (scene/textures.py TextureTable.ptex_*):
  one gather per bilinear tap, no per-face branching.  Faces are
  addressed by the triangle's face index (mesh `"integer faceIndices"`
  or the triangle's ordinal within its mesh — matching pbrt's
  SurfaceInteraction::faceIndex flow into Ptex::eval, ptex.cpp:91).
  Intra-face (u,v) is the triangle UV (pbrt's default triangle
  parameterization).  Cross-face filtering (the reference's PtexFilter
  bilinear behavior, ptex.cpp:91) is done the TPU way: at BUILD time
  each face is padded with a 1-texel border ring gathered from its
  adjacent faces via the container's adjfaces/adjedges tables
  (`pad_face_borders`), so the runtime bilinear stays one dense gather
  per tap with no per-face branching, yet border taps blend into the
  neighboring face exactly as a runtime adjacency walk would.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x78657450            # 'Ptex' little-endian
_DT_SIZE = {0: 1, 1: 2, 2: 2, 3: 4}
_DT_NP = {0: np.uint8, 1: np.uint16, 2: np.float16, 3: np.float32}

MESH_TRIANGLE = 0
MESH_QUAD = 1


class PtexFile:
    """In-memory .ptx: per-face resolutions, adjacency, texels."""

    def __init__(self):
        self.meshtype = MESH_QUAD
        self.nchannels = 3
        self.alphachan = -1
        self.res = np.zeros((0, 2), np.int32)       # (F,2) log2 u,v res
        self.adjfaces = np.zeros((0, 4), np.int32)  # (F,4)
        self.adjedges = np.zeros((0,), np.uint32)   # (F,) 4x2-bit packed
        self.const = np.zeros((0, 3), np.float32)   # (F,C) constant color
        self.faces = []                              # list of (rv,ru,C) f32


def _conv_out(datatype):
    np_dt = _DT_NP[datatype]
    if datatype == 0:
        return lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np_dt)
    if datatype == 1:
        return lambda a: np.clip(a * 65535.0 + 0.5, 0, 65535).astype(np_dt)
    return lambda a: a.astype(np_dt)


def _diff_encode(buf: bytes, datatype: int) -> bytes:
    """PtexUtils::encodeDifference: in-place d[i] -= d[i-1] over the
    integer type's units (u8/u16 only)."""
    dt = np.uint8 if datatype == 0 else np.uint16
    a = np.frombuffer(buf, dt).astype(np.int64)
    d = np.empty_like(a)
    d[0] = a[0]
    d[1:] = a[1:] - a[:-1]
    return (d % (256 if datatype == 0 else 65536)).astype(dt).tobytes()


def _diff_decode(buf: bytes, datatype: int) -> bytes:
    dt = np.uint8 if datatype == 0 else np.uint16
    a = np.frombuffer(buf, dt).astype(np.int64)
    return (np.cumsum(a) % (256 if datatype == 0 else 65536)
            ).astype(dt).tobytes()


_ENC_CONSTANT, _ENC_ZIPPED, _ENC_DIFFZIPPED, _ENC_TILED = 0, 1, 2, 3
_TILE_BYTES = 1 << 16          # Ptex tiles faces larger than 64 KiB


def _encode_face(texels: bytes, ures, vres, pixelsize, datatype):
    """-> (fdh_encoding, blockdata) for one face at one level."""
    if len(texels) <= _TILE_BYTES:
        if datatype in (0, 1):
            return _ENC_DIFFZIPPED, zlib.compress(
                _diff_encode(texels, datatype))
        return _ENC_ZIPPED, zlib.compress(texels)
    # tiled: split into tiles of ~TILE_BYTES, row-major over tiles
    tlog_u, tlog_v = int(np.log2(ures)), int(np.log2(vres))
    while (1 << (tlog_u + tlog_v)) * pixelsize > _TILE_BYTES:
        if tlog_v >= tlog_u:
            tlog_v -= 1
        else:
            tlog_u -= 1
    tu, tv = 1 << tlog_u, 1 << tlog_v
    ntu, ntv = ures // tu, vres // tv
    arr = np.frombuffer(texels, np.uint8).reshape(vres, ures * pixelsize)
    tile_blocks = []
    fdhs = []
    for tj in range(ntv):
        for ti in range(ntu):
            tile = arr[tj * tv:(tj + 1) * tv,
                       ti * tu * pixelsize:(ti + 1) * tu * pixelsize]
            enc, blk = _encode_face(tile.tobytes(), tu, tv, pixelsize,
                                    datatype)
            fdhs.append(len(blk) | (enc << 30))
            tile_blocks.append(blk)
    theader_z = zlib.compress(
        struct.pack(f"<{len(fdhs)}I", *fdhs))
    data = (struct.pack("<bbI", tlog_u, tlog_v, len(theader_z))
            + theader_z + b"".join(tile_blocks))
    return _ENC_TILED, data


def _decode_face(enc, block: bytes, ures, vres, pixelsize, datatype):
    """-> raw texel bytes (vres rows of ures pixels)."""
    n = ures * vres * pixelsize
    if enc == _ENC_CONSTANT:
        px = block[:pixelsize]
        return px * (ures * vres)
    if enc == _ENC_ZIPPED:
        raw = zlib.decompress(block)
    elif enc == _ENC_DIFFZIPPED:
        raw = _diff_decode(zlib.decompress(block), datatype)
    elif enc == _ENC_TILED:
        tlog_u, tlog_v, ths = struct.unpack_from("<bbI", block, 0)
        pos = 6
        theader = zlib.decompress(block[pos:pos + ths])
        pos += ths
        fdhs = np.frombuffer(theader, "<u4")
        tu, tv = 1 << tlog_u, 1 << tlog_v
        ntu, ntv = ures // tu, vres // tv
        if len(fdhs) != ntu * ntv:
            raise ValueError("ptex: tile header count mismatch")
        out = np.zeros((vres, ures * pixelsize), np.uint8)
        for idx, fdh in enumerate(fdhs):
            bs = int(fdh) & 0x3FFFFFFF
            tenc = int(fdh) >> 30
            traw = _decode_face(tenc, block[pos:pos + bs], tu, tv,
                                pixelsize, datatype)
            pos += bs
            tj, ti = divmod(idx, ntu)
            out[tj * tv:(tj + 1) * tv,
                ti * tu * pixelsize:(ti + 1) * tu * pixelsize] = \
                np.frombuffer(traw, np.uint8).reshape(
                    tv, tu * pixelsize)
        raw = out.tobytes()
    else:
        raise ValueError(f"ptex: unknown face encoding {enc}")
    if len(raw) != n:
        raise ValueError("ptex: face data size mismatch")
    return raw


def write_ptx(path: str, pf: PtexFile, datatype: int = 3):
    """Serialize in the Ptex v1 container layout: 56-byte header,
    zip-deflated FaceInfo records (Res + adjedges + flags + adjfaces[4],
    20 bytes each), zip-deflated const data, raw LevelInfo array, and
    one level of per-face data blocks behind a zip-deflated
    FaceDataHeader table — the layout PtexReader expects
    (ref: src/textures/ptex.cpp via the ext Ptex library's
    PtexReader::readFaceInfo/readLevel)."""
    F = len(pf.faces)
    C = pf.nchannels
    conv = _conv_out(datatype)
    pixelsize = C * _DT_SIZE[datatype]

    fi = bytearray()
    for f in range(F):
        fi += struct.pack("<bbBB4i", int(pf.res[f, 0]), int(pf.res[f, 1]),
                          int(pf.adjedges[f]) & 0xFF, 0,
                          *(int(x) for x in pf.adjfaces[f]))
    fi_z = zlib.compress(bytes(fi))
    const_z = zlib.compress(conv(pf.const.astype(np.float32)).tobytes())

    fdhs = []
    blocks = []
    for f in range(F):
        ures, vres = 1 << int(pf.res[f, 0]), 1 << int(pf.res[f, 1])
        texels = conv(np.asarray(pf.faces[f], np.float32)).tobytes()
        enc, blk = _encode_face(texels, ures, vres, pixelsize, datatype)
        fdhs.append(len(blk) | (enc << 30))
        blocks.append(blk)
    lvl_header_z = zlib.compress(struct.pack(f"<{F}I", *fdhs))
    lvl_data = lvl_header_z + b"".join(blocks)
    levelinfo = struct.pack("<QII", len(lvl_data), len(lvl_header_z), F)

    with open(path, "wb") as f:
        f.write(struct.pack("<IIIIiHHI", _MAGIC, 1, pf.meshtype, datatype,
                            pf.alphachan, C, 1, F))
        f.write(struct.pack("<IIIIQII", 0, len(fi_z), len(const_z),
                            len(levelinfo), len(lvl_data), 0, 0))
        f.write(fi_z)
        f.write(const_z)
        f.write(levelinfo)
        f.write(lvl_data)


def read_ptx(path: str) -> PtexFile:
    """Parse a Ptex v1 .ptx container (level-0 texels only; coarser
    levels are rebuilt on demand by the texture pyramid).  Handles the
    constant / zipped / diff-zipped / tiled face encodings of the real
    format."""
    with open(path, "rb") as f:
        head = f.read(24)
        if len(head) < 24:
            raise ValueError(f"{path}: truncated ptex header")
        magic, version, meshtype, datatype, alphachan, nchan, nlevels, F = \
            struct.unpack("<IIIIiHHI", head + f.read(4))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a Ptex file (magic {magic:#x})")
        if version != 1 or datatype not in _DT_SIZE:
            raise ValueError(f"{path}: unsupported ptex version/datatype")
        exth, fi_zs, const_zs, li_s, lvl_s, md_zs, md_ms = \
            struct.unpack("<IIIIQII", f.read(32))
        f.read(exth)
        fi = zlib.decompress(f.read(fi_zs))
        const_raw = zlib.decompress(f.read(const_zs))
        li = f.read(li_s)
        leveldata = f.read(lvl_s)

    pf = PtexFile()
    pf.meshtype = meshtype
    pf.nchannels = nchan
    pf.alphachan = alphachan
    rec = 20
    if len(fi) != F * rec:
        raise ValueError(f"{path}: face-info block size mismatch "
                         f"({len(fi)} != {F * rec})")
    pf.res = np.zeros((F, 2), np.int32)
    pf.adjfaces = np.zeros((F, 4), np.int32)
    pf.adjedges = np.zeros(F, np.uint32)
    flags = np.zeros(F, np.uint8)
    for i in range(F):
        vals = struct.unpack_from("<bbBB4i", fi, i * rec)
        pf.res[i] = vals[0], vals[1]
        pf.adjedges[i] = vals[2]
        flags[i] = vals[3]
        pf.adjfaces[i] = vals[4:8]

    np_dt = _DT_NP[datatype]
    scale = {0: 1 / 255.0, 1: 1 / 65535.0}.get(datatype, 1.0)
    const = np.frombuffer(const_raw, np_dt).astype(np.float32) * scale
    pf.const = const.reshape(F, nchan) if F else const.reshape(0, nchan)

    if nlevels < 1 or len(li) < 16:
        raise ValueError(f"{path}: missing level info")
    lvl_size, lvl_hsize, lvl_F = struct.unpack_from("<QII", li, 0)
    header_z = leveldata[:lvl_hsize]
    fdhs = np.frombuffer(zlib.decompress(header_z), "<u4")
    if len(fdhs) != lvl_F:
        raise ValueError(f"{path}: level-0 header count mismatch")
    pixelsize = nchan * _DT_SIZE[datatype]
    pos = lvl_hsize
    pf.faces = []
    for i in range(F):
        ures, vres = 1 << int(pf.res[i, 0]), 1 << int(pf.res[i, 1])
        if i < lvl_F:
            bs = int(fdhs[i]) & 0x3FFFFFFF
            enc = int(fdhs[i]) >> 30
        else:
            bs, enc = 0, _ENC_CONSTANT
        if bs == 0 or (flags[i] & 1):
            # constant face: fill from const data
            face = np.broadcast_to(pf.const[i], (vres, ures, nchan))
            pf.faces.append(np.ascontiguousarray(face, np.float32))
            pos += bs
            continue
        raw = _decode_face(enc, leveldata[pos:pos + bs], ures, vres,
                           pixelsize, datatype)
        pos += bs
        face = (np.frombuffer(raw, np_dt).astype(np.float32) * scale)
        pf.faces.append(face.reshape(vres, ures, nchan))
    return pf


def make_test_ptx(path: str, n_faces: int = 4, res_log2: int = 3,
                  meshtype: int = MESH_QUAD, seed: int = 0):
    """Generate a small .ptx with per-face gradient patterns (tooling +
    test fixture)."""
    rng = np.random.default_rng(seed)
    pf = PtexFile()
    pf.meshtype = meshtype
    pf.nchannels = 3
    pf.res = np.full((n_faces, 2), res_log2, np.int32)
    pf.adjfaces = np.full((n_faces, 4), -1, np.int32)
    pf.adjedges = np.zeros(n_faces, np.uint32)
    pf.const = np.zeros((n_faces, 3), np.float32)
    r = 1 << res_log2
    for i in range(n_faces):
        base = rng.uniform(0.1, 0.9, 3)
        u = np.linspace(0, 1, r)[None, :, None]
        v = np.linspace(0, 1, r)[:, None, None]
        face = np.clip(base * (0.5 + 0.5 * u) * (0.5 + 0.5 * v), 0, 1)
        pf.faces.append(face.astype(np.float32))
        pf.const[i] = face.mean(axis=(0, 1))
    write_ptx(path, pf)
    return pf


def _edge_row(face, e):
    """Edge texels of (rv,ru,C) `face` along edge e in CCW order.

    Ptex edge ids: 0=bottom (v=0, +u), 1=right (u=max, +v),
    2=top (v=max, -u), 3=left (u=0, -v)."""
    if e == 0:
        return face[0, :, :]
    if e == 1:
        return face[:, -1, :]
    if e == 2:
        return face[-1, ::-1, :]
    return face[::-1, 0, :]


def _resample_row(row, n):
    """Linearly resample a (L,C) edge row to n samples (texel centers)."""
    L = row.shape[0]
    if L == n:
        return row
    x = (np.arange(n) + 0.5) / n * L - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, L - 1)
    x1 = np.minimum(x0 + 1, L - 1)
    a = np.clip(x - x0, 0.0, 1.0)[:, None]
    return row[x0] * (1 - a) + row[x1] * a


def pad_face_borders(pf: PtexFile):
    """Return faces padded to (rv+2, ru+2, C) with a border ring taken
    from adjacent faces (cross-face bilinear; ref: textures/ptex.cpp:91
    PtexFilter).  A shared edge is traversed in opposite CCW directions
    by its two faces, so the neighbor's edge row is reversed (and
    resampled if resolutions differ).  Open edges (adjface == -1)
    replicate the face's own edge (clamp).  Corner ring texels average
    their two edge neighbors."""
    out = []
    F = len(pf.faces)
    for f, face in enumerate(pf.faces):
        rv, ru, C = face.shape
        pad = np.zeros((rv + 2, ru + 2, C), face.dtype)
        pad[1:-1, 1:-1] = face
        rows = {}
        for e, L in ((0, ru), (1, rv), (2, ru), (3, rv)):
            af = int(pf.adjfaces[f, e]) if f < len(pf.adjfaces) else -1
            if 0 <= af < F:
                ae = (int(pf.adjedges[f]) >> (2 * e)) & 3
                nrow = _edge_row(pf.faces[af], ae)[::-1]  # our CCW order
                rows[e] = _resample_row(nrow, L)
            else:
                rows[e] = _edge_row(face, e)              # clamp
        # scatter CCW-ordered rows into border cells (top/left rows are
        # CCW -u/-v, so they flip back to array order)
        pad[0, 1:-1] = rows[0]
        pad[1:-1, -1] = rows[1]
        pad[-1, 1:-1] = rows[2][::-1]
        pad[1:-1, 0] = rows[3][::-1]
        for (cy, cx), (ay, ax), (by, bx) in (
                ((0, 0), (0, 1), (1, 0)),
                ((0, -1), (0, -2), (1, -1)),
                ((-1, 0), (-1, 1), (-2, 0)),
                ((-1, -1), (-1, -2), (-2, -1))):
            pad[cy, cx] = 0.5 * (pad[ay, ax] + pad[by, bx])
        out.append(pad)
    return out


def build_face_tables(ptex_files: list):
    """Concatenate all ptex files' faces into the flat device pool.

    Faces are stored PADDED (rv+2, ru+2) with cross-face border rings
    (`pad_face_borders`); resu/resv hold the UNPADDED resolution and the
    runtime lookup addresses texel (x, y) at
    off + (y+1)*(ru+2) + (x+1) with x in [-1, ru] (textures._eval_ptex).

    Returns (bases (list per file), off, resu, resv, texels) numpy arrays
    for TextureTable.ptex_*."""
    bases, off, ru, rv = [], [], [], []
    pools = []
    total = 0
    nfaces = 0
    for pf in ptex_files:
        bases.append(nfaces)
        for face in pad_face_borders(pf):
            h, w = face.shape[:2]          # padded dims
            off.append(total)
            ru.append(w - 2)
            rv.append(h - 2)
            c = face.shape[-1]
            rgb = face[..., :3] if c >= 3 else np.repeat(
                face[..., :1], 3, axis=-1)
            pools.append(rgb.reshape(-1, 3))
            total += h * w
            nfaces += 1
    if not pools:
        return [], (np.zeros(1, np.int32), np.ones(1, np.int32),
                    np.ones(1, np.int32), np.zeros((1, 3), np.float32))
    return bases, (np.asarray(off, np.int32), np.asarray(ru, np.int32),
                   np.asarray(rv, np.int32),
                   np.concatenate(pools).astype(np.float32))
