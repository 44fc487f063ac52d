"""Baseline sequential JPEG encoder in numpy (ITU-T T.81, JFIF 1.01).

The live view (``utils/liveview``) serves its overlays and patch strips as
JPEG. The JAX package encodes them with PIL; the port encodes them here, on
every host, so that the bytes it serves do not depend on what is installed
(the card's host has no PIL). It writes what PIL writes by default: the
standard quantization tables (T.81 K.1, K.2) scaled to ``quality`` as
libjpeg scales them, the standard Huffman tables (K.3), and for RGB input
YCbCr with 4:2:0 chroma; grey input gives one component.

Every stage is vectorised over the whole image: the colour transform, the
block DCT (one matrix product per side), quantization, the run-length and
Huffman coding of every block at once, and the bit packing. No Python loop
runs per block.
"""

from __future__ import annotations

import functools

import numpy as np

# T.81 K.1 and K.2, natural (row-major) order
_Q_LUMA = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
)
_Q_CHROMA = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
) + (99,) * 32

# T.81 K.3: (code counts by length 1..16, symbols in code order)
_DC_LUMA = (
    (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
    (0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b),
)
_AC_LUMA = (
    (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
    (0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa),
)
_DC_CHROMA = (
    (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
    (0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b),
)
_AC_CHROMA = (
    (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
    (0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa),
)


def _frozen(a: np.ndarray) -> np.ndarray:
    """``a`` made read-only: the cached tables are shared by every call."""
    a.setflags(write=False)
    return a


@functools.cache
def zigzag() -> np.ndarray:
    """Natural index of each coefficient in zigzag order (T.81 A.3.6)."""
    cells = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[1] if (rc[0] + rc[1]) % 2 == 0 else rc[0]))
    return _frozen(np.array([8 * r + c for r, c in cells]))


@functools.cache
def quant_table(quality: int, chroma: bool) -> np.ndarray:
    """A standard table scaled to ``quality`` as libjpeg's
    jpeg_quality_scaling and jpeg_add_quant_table do (baseline: 1..255),
    in natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    base = np.array(_Q_CHROMA if chroma else _Q_LUMA, np.int64)
    return _frozen(np.clip((base * scale + 50) // 100, 1, 255))


@functools.cache
def _huffman(table) -> tuple[np.ndarray, np.ndarray]:
    """(code, length) of each of the 256 symbols; the canonical code of
    T.81 C.1-C.2 (length 0 for a symbol the table lacks)."""
    counts, symbols = table
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]], length[symbols[k]] = c, n_bits
            c, k = c + 1, k + 1
        c <<= 1
    return _frozen(code), _frozen(length)


@functools.cache
def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II: the 2-D transform C B C^T is T.81's
    FDCT (A.3.3)."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return _frozen(m)


def _blocks(plane: np.ndarray, by: int, bx: int) -> np.ndarray:
    """[H, W] (multiples of 8*by, 8*bx) -> [MCUs, by*bx, 8, 8] in scan order."""
    h, w = plane.shape
    b = plane.reshape(h // (8 * by), by, 8, w // (8 * bx), bx, 8)
    return b.transpose(0, 3, 1, 4, 2, 5).reshape(-1, by * bx, 8, 8)


def _pad(img: np.ndarray, mult: int) -> np.ndarray:
    h, w = img.shape[:2]
    pad = ((0, -h % mult), (0, -w % mult)) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def _category(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (T.81 F.1.2.1.1 SSSS): 0 for 0."""
    return np.ceil(np.log2(np.abs(v) + 1.0)).astype(np.int64)


def _entropy_code(zz: np.ndarray, table: np.ndarray) -> bytes:
    """Huffman-code quantized blocks ``zz`` [N, 64] (zigzag order, in scan
    order, each DC already the difference from its component's previous
    block) with table set ``table`` [N] (0 luma, 1 chroma); returns the
    entropy-coded segment, padded with 1 bits and byte-stuffed."""
    n = zz.shape[0]
    dc_tabs = (_huffman(_DC_LUMA), _huffman(_DC_CHROMA))
    ac_tabs = (_huffman(_AC_LUMA), _huffman(_AC_CHROMA))
    dc_code = np.stack([t[0] for t in dc_tabs])
    dc_len = np.stack([t[1] for t in dc_tabs])
    ac_code = np.stack([t[0] for t in ac_tabs])
    ac_len = np.stack([t[1] for t in ac_tabs])

    # events: (block, key within the block, Huffman code + extra bits);
    # sorting by (block, key) puts them in stream order
    ev_block, ev_key, ev_val, ev_len = [], [], [], []

    def emit(block, key, code, length, extra, nbits):
        ev_block.append(block)
        ev_key.append(key)
        ev_val.append((code << nbits) | extra)
        ev_len.append(length + nbits)

    # DC: size category, then the value's low bits (negative: v - 1)
    dc = zz[:, 0]
    s = _category(dc)
    extra = np.where(dc >= 0, dc, dc + (1 << s) - 1)
    emit(np.arange(n), np.zeros(n, np.int64), dc_code[table, s], dc_len[table, s], extra, s)

    # AC: each nonzero coefficient at zigzag position k (1..63) after a run
    # of r zeros codes (r mod 16, size) after r // 16 ZRLs (0xF0); a block
    # whose last nonzero is before 63 ends with EOB (0x00)
    ac = zz[:, 1:]
    bi, ki = np.nonzero(ac)
    v = ac[bi, ki]
    k = ki + 1
    first = np.ones(bi.size, bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    zrl = run // 16
    s = _category(v)
    sym = ((run % 16) << 4) | s
    t = table[bi]
    extra = np.where(v >= 0, v, v + (1 << s) - 1)
    emit(bi, 2 * k + 1, ac_code[t, sym], ac_len[t, sym], extra, s)
    zb = np.repeat(bi, zrl)
    zt = table[zb]
    zeros = np.zeros(zb.size, np.int64)
    emit(zb, np.repeat(2 * k, zrl), ac_code[zt, 0xF0], ac_len[zt, 0xF0], zeros, zeros)
    last = np.zeros(n, np.int64)
    last[bi] = k  # k rises within a block: the last write is its last nonzero
    eob = np.nonzero(last < 63)[0]
    zeros = np.zeros(eob.size, np.int64)
    emit(eob, np.full(eob.size, 200), ac_code[table[eob], 0x00], ac_len[table[eob], 0x00],
         zeros, zeros)

    block = np.concatenate(ev_block)
    order = np.lexsort((np.concatenate(ev_key), block))
    val = np.concatenate(ev_val)[order]
    length = np.concatenate(ev_len)[order]

    # pack: every event's bits, most significant first, then 1s to a byte
    total = int(length.sum())
    start = np.cumsum(length) - length
    which = np.repeat(np.arange(length.size), length)
    shift = length[which] - 1 - (np.arange(total) - start[which])
    bits = ((val[which] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()  # byte stuffing (F.1.2.3)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht(tc: int, table) -> bytes:
    counts, symbols = table
    return bytes([tc, *counts, *symbols])


def encode(img: np.ndarray, quality: int = 85) -> bytes:
    """JPEG bytes of ``img``: [H, W, 3] RGB or [H, W] grey, uint8 (other
    dtypes are clipped to 0..255 and rounded)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"need an [H, W] or [H, W, 3] image, got {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"image size {w}x{h} out of JPEG's range")
    color = img.ndim == 3
    x = img.astype(np.float64)
    if color:
        x = _pad(x, 16)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

        def sub(c):  # 4:2:0, each chroma sample the mean of a 2x2 cell
            return 0.25 * (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2])

        mcus = np.concatenate([_blocks(y, 2, 2), _blocks(sub(cb), 1, 1),
                               _blocks(sub(cr), 1, 1)], axis=1)
        comp = np.array([0, 0, 0, 0, 1, 2])
    else:
        mcus = _blocks(_pad(x, 8), 1, 1)
        comp = np.array([0])
    comp = np.tile(comp, mcus.shape[0])
    table = (comp > 0).astype(np.int64)
    d = _dct_matrix()
    coef = d @ (mcus.reshape(-1, 8, 8) - 128.0) @ d.T
    q = np.stack([quant_table(quality, False), quant_table(quality, True)])
    zz_nat = coef.reshape(-1, 64) / q[table]
    quantized = (np.sign(zz_nat) * np.floor(np.abs(zz_nat) + 0.5)).astype(np.int64)
    zz = quantized[:, zigzag()]
    # DC prediction per component, in scan order
    for c in range(comp.max() + 1):
        sel = np.nonzero(comp == c)[0]
        dc = zz[sel, 0]
        zz[sel, 0] = dc - np.concatenate([[0], dc[:-1]])

    ncomp = 3 if color else 1
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    dqt = b"".join(bytes([i]) + quant_table(quality, bool(i))[zigzag()].astype(np.uint8).tobytes()
                   for i in range(2 if color else 1))
    out.append(_segment(0xDB, dqt))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([ncomp])
    if color:
        sof += bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    else:
        sof += bytes([1, 0x11, 0])
    out.append(_segment(0xC0, sof))
    dht = _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
    if color:
        dht += _dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA)
    out.append(_segment(0xC4, dht))
    sos = bytes([ncomp]) + (bytes([1, 0x00, 2, 0x11, 3, 0x11]) if color else bytes([1, 0x00]))
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out.append(_entropy_code(zz, table))
    out.append(b"\xff\xd9")
    return b"".join(out)
