"""COCO mask codec and polygon rasterization in numpy (counterpart of
``labelanything_tpu/data/rle.py``; reference: data/transforms.py:76-100).

``decode``, ``encode`` and ``merge`` are the JAX package's numpy codec
(COCO compressed RLE, column-major). ``poly_to_mask`` is the JAX package's
``ImageDraw.polygon(pts, outline=1, fill=1)`` on a mode "L" image without
PIL: with the outline ink equal to the fill ink PIL draws the fill alone,
and :func:`fill_polygon` is that fill (Pillow's ``polygon_generic``) in
numpy, float32 scanline arithmetic included:

* vertex coordinates are truncated toward zero;
* horizontal edges are drawn as lines and left out of the scan;
* every row from the top vertex to the bottom one (clipped to the image)
  intersects each edge it crosses at ``(y - y0) * dx + x0`` in float32; an
  edge that ends on the row, below the polygon's last row, counts twice;
* where two edges that slope the same way meet at a vertex on an integer
  column (both start or both end on the row), the intersection moves to
  the column next to the neighbouring row's (Pillow's "connect
  discontiguous corners");
* the sorted intersections pair up into spans ``[round_up(a),
  round_down(b)]``, clipped to the image.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLEObj = Dict[str, Union[str, bytes, List[int], Sequence[int]]]

_F32 = np.float32


def _counts_to_array(counts: Union[str, bytes, Sequence[int]]) -> np.ndarray:
    if isinstance(counts, (list, tuple, np.ndarray)):
        return np.asarray(counts, dtype=np.int64)
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    # COCO compressed RLE: 6-bit chunks, LSB-first, bit 5 = continuation,
    # delta-coded against counts[i-2] for i > 2
    out: List[int] = []
    pos = 0
    n = len(counts)
    while pos < n:
        x = 0
        k = 0
        more = True
        while more:
            c = counts[pos] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return np.asarray(out, dtype=np.int64)


def _array_to_counts(arr: Sequence[int]) -> str:
    out = bytearray()
    arr = list(arr)
    for i, x in enumerate(arr):
        if i > 2:
            x -= arr[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def _runs_to_mask(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    return np.repeat(vals, counts).reshape(w, h).T  # column-major


def decode(rle: RLEObj) -> np.ndarray:
    """Decode an RLE object to a (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = _counts_to_array(rle["counts"])
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != {h}*{w}")
    return _runs_to_mask(counts, h, w)


def encode(mask: np.ndarray) -> RLEObj:
    """Encode a (H, W) binary mask to compressed RLE."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
    changes = np.flatnonzero(np.diff(flat)) + 1
    boundaries = np.concatenate([[0], changes, [flat.size]])
    runs = np.diff(boundaries).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    if not runs:
        runs = [h * w]
    return {"size": [h, w], "counts": _array_to_counts(runs)}


def merge(rles: List[RLEObj]) -> RLEObj:
    """OR-merge RLEs."""
    if len(rles) == 1:
        return rles[0]
    mask = np.zeros(tuple(rles[0]["size"]), dtype=np.uint8)
    for r in rles:
        mask |= decode(r)
    return encode(mask)


# -- polygon fill ----------------------------------------------------------- #

def _round_half_away(v: np.ndarray) -> np.ndarray:
    """C's ``roundf`` on float32 values, as float32."""
    v = np.asarray(v, _F32)
    mag = np.floor(np.abs(v) + _F32(0.5))
    return np.where(v >= 0, mag, -mag).astype(_F32)


def _round_up(v: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_UP`` of float32 values."""
    v = np.asarray(v, _F32)
    mag = np.floor(np.abs(v) + _F32(0.5))
    return np.where(v >= 0, mag, -mag).astype(np.int64)


def _round_down(v: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_DOWN`` of float32 values."""
    v = np.asarray(v, _F32)
    mag = np.ceil(np.abs(v) - _F32(0.5))
    return np.where(v >= 0, mag, -mag).astype(np.int64)


def _vertices(pts: Sequence[float]) -> np.ndarray:
    """(k, 2) integer vertices: float coordinates truncated toward zero, as
    Pillow's ``draw_polygon`` takes them."""
    return np.trunc(np.asarray(pts, np.float64).reshape(-1, 2)).astype(
        np.int64)


def fill_polygon(mask: np.ndarray, pts: Sequence[float]) -> np.ndarray:
    """Set to 1 the pixels of ``mask`` (H, W) that Pillow's polygon fill
    covers for the vertices ``pts`` ([x0, y0, x1, y1, ...]); in place."""
    h, w = mask.shape
    xy = _vertices(pts)
    if len(xy) == 0:
        return mask
    a = xy
    b = np.roll(xy, -1, axis=0)
    if (a[-1] == a[0]).all():                 # no closing edge
        a, b = a[:-1], b[:-1]
    spans = []                                # (y, x_start, x_end)

    horiz = a[:, 1] == b[:, 1]
    for (x0, y), (x1, _) in zip(a[horiz], b[horiz]):
        spans.append((y, min(x0, x1), max(x0, x1)))
    ymin = min(h - 1, int(min(a[:, 1].min(), b[:, 1].min())))
    ymax = max(0, int(max(a[:, 1].max(), b[:, 1].max())))
    ymin, ymax = max(ymin, 0), min(ymax, h)

    ea, eb = a[~horiz], b[~horiz]
    if len(ea) and ymin <= ymax:
        x0, y0 = ea[:, 0], ea[:, 1]
        e_ymin = np.minimum(ea[:, 1], eb[:, 1])
        e_ymax = np.maximum(ea[:, 1], eb[:, 1])
        dx = ((eb[:, 0] - x0).astype(_F32)
              / (eb[:, 1] - y0).astype(_F32)).astype(_F32)

        def x_at(e, y):
            return ((np.asarray(y - y0[e]).astype(_F32) * dx[e])
                    .astype(_F32) + x0[e].astype(_F32)).astype(_F32)

        rows = np.arange(ymin, ymax + 1)
        active = ((rows[:, None] >= e_ymin[None]) &
                  (rows[:, None] <= e_ymax[None]))       # (R, E)
        r_idx, e_idx = np.nonzero(active)                # row-major order
        ys = rows[r_idx]
        xs = x_at(e_idx, ys)
        dup = (ys == e_ymax[e_idx]) & (ys < ymax)

        # corners: an intersection on an integer column at a vertex where
        # an earlier edge sloping the same way starts (or ends) too
        cand = np.flatnonzero(~dup & (dx[e_idx] != 0)
                              & (_round_half_away(xs) == xs))
        for c in cand:
            y, i = int(ys[c]), int(e_idx[c])
            at_min, at_max = y == e_ymin[i], y == e_ymax[i]
            if not (at_min or at_max):
                continue
            for k in range(i):
                if (dx[i] > 0 and dx[k] <= 0) or (dx[i] < 0 and dx[k] >= 0):
                    continue
                joined = ((at_min and y == e_ymin[k])
                          or (at_max and y == e_ymax[k]))
                if not (joined and xs[c] == _round_half_away(x_at(k, y))):
                    continue
                off = -1 if y == ymax else 1
                adj = x_at(i, y + off)
                adj_other = x_at(k, y + off)
                if xs[c] > adj + 1 and xs[c] > adj_other + 1:
                    xs[c] = _round_half_away(max(adj, adj_other)) + 1
                elif xs[c] < adj - 1 and xs[c] < adj_other - 1:
                    xs[c] = _round_half_away(min(adj, adj_other)) - 1
                break

        ys = np.concatenate([ys, ys[dup]])
        xs = np.concatenate([xs, xs[dup]])
        order = np.lexsort((xs, ys))
        ys, xs = ys[order], xs[order]
        first = np.r_[0, np.flatnonzero(np.diff(ys)) + 1]
        pos = np.arange(len(ys)) - np.repeat(first, np.diff(np.r_[first,
                                                                  len(ys)]))
        left = np.flatnonzero((pos % 2 == 0)[:-1] & (ys[1:] == ys[:-1]))
        starts, ends = _round_up(xs[left]), _round_down(xs[left + 1])
        spans.extend(zip(ys[left].tolist(), starts.tolist(), ends.tolist()))

    if not spans:
        return mask
    sp = np.asarray(spans, np.int64).reshape(-1, 3)
    y, xa, xb = sp[:, 0], np.maximum(sp[:, 1], 0), np.minimum(sp[:, 2], w - 1)
    keep = (y >= 0) & (y < h) & (xa <= xb) & (xa < w) & (xb >= 0)
    y, xa, xb = y[keep], xa[keep], xb[keep]
    diff = np.zeros((h, w + 1), np.int32)
    np.add.at(diff, (y, xa), 1)
    np.add.at(diff, (y, xb + 1), -1)
    mask[np.cumsum(diff[:, :w], axis=1) > 0] = 1
    return mask


def poly_to_mask(polygons: List[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon(s) [x0, y0, x1, y1, ...] to a (H, W) uint8
    mask, each polygon of three points or more filled as Pillow fills it."""
    mask = np.zeros((h, w), np.uint8)
    for poly in polygons:
        if len(poly) // 2 >= 3:
            fill_polygon(mask, poly[: len(poly) // 2 * 2])
    return mask


def ann_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Annotation (polygons / uncompressed RLE / RLE) -> binary mask
    (reference: data/transforms.py:76-100 + 123-149 degenerate fallback)."""
    if isinstance(segm, list):
        mask = poly_to_mask(segm, h, w)
        if not mask.any() and segm and len(segm[0]) >= 2:
            fp_x = min(max(int(segm[0][0]), 0), w - 1)
            fp_y = min(max(int(segm[0][1]), 0), h - 1)
            mask[fp_y, fp_x] = 1
        return mask
    if isinstance(segm.get("counts"), list):
        mask = _runs_to_mask(np.asarray(segm["counts"], dtype=np.int64), h, w)
    else:
        mask = decode(segm)
    if not mask.any():
        mask = mask.copy()
        mask[0, 0] = 1
    return mask
