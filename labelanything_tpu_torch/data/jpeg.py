"""JPEG decoding without PIL: what ``np.asarray(PIL.Image.open(path))``
gives for a JPEG file, bit for bit, on a machine that has no PIL.

PIL decodes with libjpeg-turbo at its defaults, and both decoders here
follow that library's arithmetic rather than a textbook's: the islow
integer IDCT (``jidctint.c``: 13 constant bits, 2 pass-1 bits), fancy
upsampling of subsampled chroma (``jdsample.c``: ``h2v1``, ``h1v2`` and
``h2v2``, edge samples repeated), the fixed-point YCbCr tables of
``jdcolor.c``, and the colour space ``jdapimin.c`` guesses from the JFIF
and Adobe markers. A four-component file comes back as PIL holds it:
CMYK inverted (its rawmode "CMYK;I"), YCCK first turned into CMYK.

Taken: baseline, extended and progressive Huffman files of 8-bit samples,
1, 3 or 4 components, sampling ratios of 1 or 2 either way (4:4:4, 4:2:2,
4:2:0, 4:4:0), restart intervals, optimised Huffman tables. Arithmetic
coding, lossless and hierarchical files, other precisions and DNL raise a
``ValueError`` that names the feature.

Two versions:

* :func:`decode_jpeg` is ``csrc/jpeg_decode.c``, in the host library that
  ``data/native.py`` builds at first use with the system C compiler;
  ctypes releases the GIL for the call, so a loader's threads decode in
  parallel. When the library cannot be built or loaded the call raises:
  it never falls back to the plain version.
* :func:`decode_jpeg_plain` is the same algorithm in numpy with a Python
  Huffman loop, for the tests at small sizes.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from . import native

MODES = {1: "L", 3: "RGB", 4: "CMYK"}


def decode_jpeg(data: bytes) -> np.ndarray:
    """The decoded image of a JPEG file's bytes: (H, W) uint8 for one
    component ("L"), (H, W, 3) for three ("RGB"), (H, W, 4) for four
    ("CMYK"), by the C decoder."""
    lib = native.load_library()
    data = bytes(data)
    err = ctypes.create_string_buffer(256)
    hwc = (ctypes.c_int * 3)()
    if lib.la_jpeg_info(data, len(data), hwc, err, len(err)) != 0:
        raise ValueError(err.value.decode())
    h, w, c = hwc
    if c not in MODES:
        raise ValueError(f"JPEG: {c} components are not supported "
                         "(1, 3 or 4)")
    out = np.empty((h, w, c), np.uint8)
    if lib.la_jpeg_decode(data, len(data), out.ctypes.data, out.size, err,
                          len(err)) != 0:
        raise ValueError(err.value.decode())
    return out[:, :, 0] if c == 1 else out


# ---- the plain version ------------------------------------------------------ #

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63])
_ZZ = ZIGZAG.tolist()

_FEATURES = {
    0xC3: "lossless (SOF3) files are",
    **{m: f"hierarchical (differential, SOF{m - 0xC0}) files are"
       for m in (0xC5, 0xC6, 0xC7)},
    **{m: f"arithmetic coding (SOF{m - 0xC0}) is"
       for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)},
    0xCC: "arithmetic coding (DAC) is",
    0xDE: "hierarchical files (DHP / EXP) are",
    0xDF: "hierarchical files (DHP / EXP) are",
    0xDC: "DNL (height given after the scan) is",
}


class _Huff:
    """A Huffman table: every 16-bit window to (length << 8) | value, 0
    where no code matches (libjpeg decodes that as 0)."""

    def __init__(self, counts: List[int], values: bytes):
        look = [0] * 65536
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                span = 1 << (16 - length)
                look[code * span:(code + 1) * span] = (
                    [(length << 8) | values[k]] * span)
                code += 1
                k += 1
            if code > (1 << length):
                raise ValueError("JPEG: bad Huffman table")
            code <<= 1
        self.look = look


class _Bits:
    """libjpeg's bit reader over a scan: 0xFF00 is a data 0xFF, a restart
    marker is skipped where a restart is due, and from any other marker
    on the reader yields zeros."""

    def __init__(self, data: bytes, pos: int):
        # unstuffed bytes of each restart interval and where the scan ends
        intervals, cur, n = [], bytearray(), len(data)
        while pos < n:
            c = data[pos]
            if c != 0xFF:
                cur.append(c)
                pos += 1
                continue
            q = pos + 1
            while q < n and data[q] == 0xFF:
                q += 1
            if q < n and data[q] == 0:
                cur.append(0xFF)
                pos = q + 1
            elif q < n and 0xD0 <= data[q] <= 0xD7:
                intervals.append(bytes(cur))
                cur = bytearray()
                pos = q + 1
            else:
                pos = q - 1 if q < n else n
                break
        intervals.append(bytes(cur))
        self.end = pos
        self.intervals = intervals
        self.index = 0
        self._start(intervals[0])

    def _start(self, seg: bytes) -> None:
        self.d = seg + bytes(8)
        self.bit = 0

    def restart(self) -> None:
        self.index += 1
        self._start(self.intervals[self.index]
                    if self.index < len(self.intervals) else b"")

    def _window(self) -> int:
        i = self.bit >> 3
        if i + 3 > len(self.d):
            self.d += bytes(len(self.d) + 8)
        return (int.from_bytes(self.d[i:i + 3], "big")
                >> (8 - (self.bit & 7))) & 0xFFFF

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        v = self._window() >> (16 - n)
        self.bit += n
        return v

    def decode(self, h: _Huff) -> int:
        e = h.look[self._window()]
        if e == 0:
            return 0
        self.bit += e >> 8
        return e & 255


def _extend(x: int, s: int) -> int:
    return x - (1 << s) + 1 if x < (1 << (s - 1)) else x


class _Comp:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None
        self.pred = 0


def _parse_sof(s: bytes, marker: int):
    if s[0] != 8:
        raise ValueError(f"JPEG: {s[0]}-bit samples are not supported "
                         "(8-bit only)")
    height, width, nc = int.from_bytes(s[1:3], "big"), \
        int.from_bytes(s[3:5], "big"), s[5]
    if height == 0:
        raise ValueError("JPEG: DNL (height given after the scan) is not "
                         "supported")
    if nc not in MODES:
        raise ValueError(f"JPEG: {nc} components are not supported "
                         "(1, 3 or 4)")
    comps = [_Comp(s[6 + 3 * c], s[7 + 3 * c] >> 4, s[7 + 3 * c] & 15,
                   s[8 + 3 * c]) for c in range(nc)]
    return height, width, comps, marker == 0xC2


def _decode_scan(st: dict, data: bytes, pos: int, s: bytes) -> int:
    comps, tables = st["comps"], st
    ns = s[0]
    scomps = []
    for i in range(ns):
        cid = s[1 + 2 * i]
        match = [c for c in comps if c.id == cid]
        if not match:
            raise ValueError("JPEG: scan names an unknown component")
        c = match[0]
        c.td, c.ta = s[2 + 2 * i] >> 4, s[2 + 2 * i] & 15
        scomps.append(c)
    ss, se = s[1 + 2 * ns], s[2 + 2 * ns]
    ah, al = s[3 + 2 * ns] >> 4, s[3 + 2 * ns] & 15
    prog = st["progressive"]
    dc_scan = ss == 0
    if prog:
        if (se != 0) if dc_scan else (se < ss or se > 63 or ns != 1):
            raise ValueError("JPEG: bad progressive scan parameters")
    elif (ss, se, ah, al) != (0, 63, 0, 0):
        raise ValueError("JPEG: bad sequential scan parameters")
    for c in scomps:
        if c.q is None:
            if c.tq not in tables["qt"]:
                raise ValueError(f"JPEG: quantization table {c.tq} is not "
                                 "defined")
            c.q = tables["qt"][c.tq]
        c.pred = 0
    bits = _Bits(data, pos)
    restart = st["restart"]
    if ns == 1:
        per_row, units = scomps[0].wib, scomps[0].wib * scomps[0].hib
    else:
        per_row, units = st["mcux"], st["mcux"] * st["mcuy"]
    eobrun = 0
    p1, m1 = 1 << al, -(1 << al)
    for m in range(units):
        if restart and m and m % restart == 0:
            bits.restart()
            for c in scomps:
                c.pred = 0
            eobrun = 0
        my, mx = divmod(m, per_row)
        for c in scomps:
            if ns == 1:
                positions = [(my, mx)]
            else:
                positions = [(my * c.v + by, mx * c.h + bx)
                             for by in range(c.v) for bx in range(c.h)]
            dc = tables["dc"].get(c.td)
            ac = tables["ac"].get(c.ta)
            for row, col in positions:
                blk = c.coef[row][col]
                if not prog or (dc_scan and ah == 0):
                    t = bits.decode(dc)
                    c.pred += _extend(bits.get(t), t) if t else 0
                    blk[0] = c.pred << al if prog else c.pred
                    if prog:
                        continue
                    k = 1
                    while k < 64:
                        rs = bits.decode(ac)
                        r, t = rs >> 4, rs & 15
                        if t:
                            k += r
                            blk[_ZZ[k]] = _extend(bits.get(t), t)
                        elif r != 15:
                            break
                        else:
                            k += 15
                        k += 1
                elif dc_scan:
                    if bits.get(1):
                        blk[0] |= p1
                elif ah == 0:
                    if eobrun > 0:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        rs = bits.decode(ac)
                        r, t = rs >> 4, rs & 15
                        if t:
                            k += r
                            blk[_ZZ[k]] = _extend(bits.get(t), t) << al
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + (bits.get(r) if r else 0) - 1
                            break
                        k += 1
                else:
                    k = ss
                    if eobrun == 0:
                        while k <= se:
                            rs = bits.decode(ac)
                            r, t = rs >> 4, rs & 15
                            if t:
                                t = p1 if bits.get(1) else m1
                            elif r != 15:
                                eobrun = (1 << r) + (bits.get(r) if r else 0)
                                break
                            while k <= se:
                                z = _ZZ[k]
                                if blk[z] != 0:
                                    if bits.get(1) and (blk[z] & p1) == 0:
                                        blk[z] += p1 if blk[z] >= 0 else m1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if t:
                                blk[_ZZ[k]] = t
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            z = _ZZ[k]
                            if blk[z] != 0 and bits.get(1) \
                                    and (blk[z] & p1) == 0:
                                blk[z] += p1 if blk[z] >= 0 else m1
                            k += 1
                        eobrun -= 1
    return bits.end


_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
            f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
            f2562=20995, f3072=25172)


def _idct_1d(d: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of jidctint.c on the 8 lanes ``d`` (int64 arrays),
    descaled by ``shift``."""
    f = _FIX
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * f["f0541"]
    t2 = z1 + z3 * -f["f1847"]
    t3 = z1 + z2 * f["f0765"]
    t0 = (d[0] + d[4]) << 13
    t1 = (d[0] - d[4]) << 13
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    out = [t10 + t3, t11 + t2, t12 + t1, t13 + t0,
           t13 - t0, t12 - t1, t11 - t2, t10 - t3]
    return [(o + half) >> shift for o in out]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(..., 8, 8) coefficients (natural order) and their quantization
    table to (..., 8, 8) uint8 samples: jidctint.c's two passes, the
    result saturated as libjpeg-turbo's SIMD IDCT saturates it."""
    x = coef.astype(np.int64) * q.reshape(8, 8).astype(np.int64)
    cols = _idct_1d([x[..., r, :] for r in range(8)], 11)
    ws = np.stack(cols, axis=-2)
    rows = _idct_1d([ws[..., :, c] for c in range(8)], 18)
    out = np.stack(rows, axis=-1) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


def _h2(cs: np.ndarray, vert: bool) -> np.ndarray:
    """jdsample.c's h2v1 (``vert`` False) or h2v2 (``cs`` = 3 x nearer +
    farther row) fancy horizontal step on (rows, w); edges repeat."""
    left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
    right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
    out = np.empty((cs.shape[0], 2 * cs.shape[1]), np.int64)
    if vert:
        out[:, 0::2] = (cs * 3 + left + 8) >> 4
        out[:, 1::2] = (cs * 3 + right + 7) >> 4
    else:
        out[:, 0::2] = (cs * 3 + left + 1) >> 2
        out[:, 1::2] = (cs * 3 + right + 2) >> 2
    return out


def _upsample(plane: np.ndarray, rh: int, rv: int, height: int,
              width: int) -> np.ndarray:
    """A component's (dsh, dsw) samples to the (height, width) frame."""
    x = plane.astype(np.int64)
    h, w = x.shape
    if rv == 2:
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        if rh == 1:
            out = np.empty((2 * h, w), np.int64)
            out[0::2] = (x * 3 + above + 1) >> 2
            out[1::2] = (x * 3 + below + 2) >> 2
        elif w > 2:
            out = np.empty((2 * h, 2 * w), np.int64)
            out[0::2] = _h2(x * 3 + above, True)
            out[1::2] = _h2(x * 3 + below, True)
        else:
            out = np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)
    elif rh == 2:
        out = _h2(x, False) if w > 2 else np.repeat(x, 2, axis=1)
    else:
        out = x
    return out[:height, :width].astype(np.uint8)


def _colour_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def decode_jpeg_plain(data: bytes) -> np.ndarray:
    """:func:`decode_jpeg`'s result by the numpy version."""
    data = bytes(data)
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: not a JPEG file (no SOI marker)")
    st = {"qt": {}, "dc": {}, "ac": {}, "restart": 0, "comps": None}
    jfif = adobe = False
    adobe_transform = 0
    pos, n, scans = 2, len(data), 0
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if m in (0x00, 0x01) or 0xD0 <= m <= 0xD8:
            continue
        if pos + 2 > n:
            raise ValueError("JPEG: truncated marker segment")
        length = int.from_bytes(data[pos:pos + 2], "big") - 2
        s = data[pos + 2:pos + 2 + length]
        if length < 0 or len(s) < length:
            raise ValueError("JPEG: truncated marker segment")
        pos += 2 + length
        if m in _FEATURES:
            raise ValueError(f"JPEG: {_FEATURES[m]} not supported")
        if m in (0xC0, 0xC1, 0xC2):
            if st["comps"] is not None:
                raise ValueError("JPEG: more than one frame header")
            height, width, comps, prog = _parse_sof(s, m)
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            st.update(comps=comps, progressive=prog,
                      mcux=-(-width // (8 * hmax)),
                      mcuy=-(-height // (8 * vmax)))
            for c in comps:
                if hmax % c.h or vmax % c.v or hmax // c.h > 2 \
                        or vmax // c.v > 2:
                    raise ValueError(
                        f"JPEG: sampling factors {c.h}x{c.v} against "
                        f"{hmax}x{vmax} are not supported (ratios of 1 or 2 "
                        "only)")
                c.dsw = -(-width * c.h // hmax)
                c.dsh = -(-height * c.v // vmax)
                c.wib, c.hib = -(-c.dsw // 8), -(-c.dsh // 8)
                c.coef = [[[0] * 64 for _ in range(st["mcux"] * c.h)]
                          for _ in range(st["mcuy"] * c.v)]
        elif m == 0xC4:
            i = 0
            while i < length:
                tc, th = s[i] >> 4, s[i] & 15
                counts = list(s[i + 1:i + 17])
                total = sum(counts)
                st["ac" if tc else "dc"][th] = _Huff(
                    counts, s[i + 17:i + 17 + total])
                i += 17 + total
        elif m == 0xDB:
            i = 0
            while i < length:
                pq, tq = s[i] >> 4, s[i] & 15
                raw = np.frombuffer(s[i + 1:i + 1 + 64 * (pq + 1)],
                                    ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[ZIGZAG[:64]] = raw
                st["qt"][tq] = q
                i += 1 + 64 * (pq + 1)
        elif m == 0xDD:
            st["restart"] = int.from_bytes(s[:2], "big")
        elif m == 0xE0:
            jfif = jfif or (length >= 14 and s[:5] == b"JFIF\0")
        elif m == 0xEE:
            if length >= 12 and s[:5] == b"Adobe":
                adobe, adobe_transform = True, s[11]
        elif m == 0xDA:
            if st["comps"] is None:
                raise ValueError("JPEG: scan before the frame header")
            pos = _decode_scan(st, data, pos, s)
            scans += 1
    if st["comps"] is None:
        raise ValueError("JPEG: no frame header")
    if not scans:
        raise ValueError("JPEG: no scan")
    comps = st["comps"]
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.q is None:
            raise ValueError(f"JPEG: component {c.id} has no scan")
        coef = np.asarray(c.coef, np.int64)[:c.hib, :c.wib].reshape(
            c.hib, c.wib, 8, 8)
        samples = idct_islow(coef, c.q).transpose(0, 2, 1, 3).reshape(
            c.hib * 8, c.wib * 8)[:c.dsh, :c.dsw]
        planes.append(_upsample(samples, hmax // c.h, vmax // c.v,
                                height, width))
    if len(comps) == 1:
        return planes[0]
    if len(comps) == 3:
        if jfif:
            ycc = True
        elif adobe:
            ycc = adobe_transform != 0
        else:
            ycc = [c.id for c in comps] != [82, 71, 66]
    else:
        ycc = adobe and adobe_transform != 0
    if ycc:
        cr_r, cb_b, cr_g, cb_g = _colour_tables()
        y, cb, cr = (p.astype(np.int64) for p in planes[:3])
        rgb = [y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]]
        if len(comps) == 4:
            rgb = [255 - v for v in rgb]
        chans = [np.clip(v, 0, 255).astype(np.uint8) for v in rgb]
        chans += planes[3:]
    else:
        chans = planes
    out = np.stack(chans, axis=-1)
    return 255 - out if len(comps) == 4 else out
