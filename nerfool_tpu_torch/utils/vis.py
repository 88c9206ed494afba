"""Image dumps without an imaging package: ``to8b``, ``colorize_np`` with
matplotlib's ``jet`` written in numpy, and a PNG writer on ``zlib``
(port of ``nerfool_tpu/utils/vis.py``). Other colormaps and the colorbar
(``get_vertical_colorbar``, ``colorize_np(append_cbar=True)``) draw with
matplotlib and resize with cv2, as the JAX package does, and import them
inside the call: where they are missing, they raise ``ImportError``.
"""
from __future__ import annotations

import importlib
import struct
import zlib

import numpy as np

TINY = 1e-6

# matplotlib's jet: (x, y0, y1) segments per channel (``_cm._jet_data``)
_JET = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
     (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)
_N = 256


def _segment_lut(data, n=_N):
    """A channel's n-entry table, interpolated from its segments as
    matplotlib's ``_create_lookup_table`` does (gamma 1)."""
    a = np.asarray(data, np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


# n colours, then under (the first), over (the last), bad (black)
JET_LUT = np.concatenate([np.stack([_segment_lut(c) for c in _JET], -1),
                          np.zeros((3, 3))])
JET_LUT[_N], JET_LUT[_N + 1] = JET_LUT[0], JET_LUT[_N - 1]


def jet(x):
    """matplotlib's ``colormaps['jet'](x)[..., :3]`` for float ``x``."""
    xa = np.array(x, np.float64) * _N
    xa[xa == _N] = _N - 1
    under, over, bad = xa < 0, xa >= _N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over], idx[bad] = _N, _N + 1, _N + 2
    return JET_LUT[idx]


def to8b(x):
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _require(name, what):
    """The module ``name``, or an ImportError that says ``what`` needs it."""
    try:
        return importlib.import_module(name)
    except ImportError as e:
        raise ImportError(f"{what} needs the {name.split('.')[0]!r} package, "
                          "which does not import here (only jet without a "
                          "colorbar is built in)") from e


def get_vertical_colorbar(h, vmin, vmax, cmap_name="jet", label=None,
                          cbar_precision=2):
    """A vertical colorbar of ``cmap_name`` over [vmin, vmax] with six tick
    labels, drawn by matplotlib and resized by cv2 to height ``h``:
    [h, w, 3] float32 in [0, 1]."""
    what = "get_vertical_colorbar"
    mpl = _require("matplotlib", what)
    cv2 = _require("cv2", what)
    agg = _require("matplotlib.backends.backend_agg", what)
    figure = _require("matplotlib.figure", what)  # imports .colorbar

    fig = figure.Figure(figsize=(2, 8), dpi=100)
    fig.subplots_adjust(right=1.5)
    canvas = agg.FigureCanvasAgg(fig)
    ax = fig.add_subplot(111)
    cmap = mpl.colormaps[cmap_name]
    norm = mpl.colors.Normalize(vmin=vmin, vmax=vmax)
    tick_loc = np.linspace(vmin, vmax, 6)
    cb = mpl.colorbar.ColorbarBase(ax, cmap=cmap, norm=norm, ticks=tick_loc,
                                   orientation="vertical")
    labels = [str(np.round(x, cbar_precision)) for x in tick_loc]
    if cbar_precision == 0:
        labels = [x[:-2] for x in labels]
    cb.set_ticklabels(labels)
    cb.ax.tick_params(labelsize=18, rotation=0)
    if label is not None:
        cb.set_label(label)
    fig.tight_layout()
    canvas.draw()
    s, (width, height) = canvas.print_to_buffer()
    im = np.frombuffer(s, np.uint8).reshape((height, width, 4))
    im = im[:, :, :3].astype(np.float32) / 255.0
    if h != im.shape[0]:
        w = int(im.shape[1] / im.shape[0] * h)
        im = cv2.resize(im, (w, h), interpolation=cv2.INTER_AREA)
    return im


def colorize_np(x, cmap_name="jet", mask=None, range=None, append_cbar=False,
                cbar_in_image=False, cbar_precision=2):
    """Grayscale [H, W] -> coloured [H, W, 3] float in [0, 1], over
    ``range`` (vmin, vmax), else over the masked pixels' nonzero minimum and
    maximum (pixels outside ``mask`` white), else over the 1st to 100th
    percentile. ``jet`` is the built-in table; another ``cmap_name`` is
    matplotlib's. ``append_cbar``: a colorbar (``get_vertical_colorbar``)
    over the image's right edge with ``cbar_in_image``, else beside it
    after 5 black columns."""
    x = np.asarray(x, dtype=np.float64).copy()
    if range is not None:
        vmin, vmax = range
    elif mask is not None:
        nz = x[mask][np.nonzero(x[mask])]
        vmin = np.min(nz) if nz.size else 0.0
        vmax = np.max(x[mask]) if x[mask].size else 1.0
        x[np.logical_not(mask)] = vmin
    else:
        vmin, vmax = np.percentile(x, (1, 100))
        vmax += TINY
    x = np.clip(x, vmin, vmax)
    x = (x - vmin) / (vmax - vmin + TINY)
    if cmap_name == "jet":
        out = jet(x)
    else:
        mpl = _require("matplotlib", f"colorize_np(cmap_name={cmap_name!r})")
        out = mpl.colormaps[cmap_name](x)[:, :, :3]
    if mask is not None:
        m = np.float32(mask[:, :, None])
        out = out * m + np.ones_like(out) * (1.0 - m)
    if append_cbar:
        cbar = get_vertical_colorbar(x.shape[0], vmin, vmax, cmap_name,
                                     cbar_precision=cbar_precision)
        if cbar_in_image:
            out[:, -cbar.shape[1]:, :] = cbar
        else:
            out = np.concatenate((out, np.zeros_like(out[:, :5, :]), cbar),
                                 axis=1)
    return out


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path, array):
    """Write a uint8 [H, W, 3] RGB image or a uint16 [H, W] grey one
    (big-endian samples, as PNG stores them) as a PNG."""
    a = np.asarray(array)
    if not ((a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3)
            or (a.dtype == np.uint16 and a.ndim == 2)):
        raise ValueError(f"write_png: uint8 [H, W, 3] or uint16 [H, W]; got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    color_type = 0 if a.ndim == 2 else 2
    rows = np.ascontiguousarray(a.astype(a.dtype.newbyteorder(">"))
                                ).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * a.dtype.itemsize, color_type,
                       0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _unfilter(raw, h, row_bytes, bpp):
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth). Average and
    Paeth predict each byte from the decoded one before it, so they run as
    a loop over the row's bytes, on Python ints (faster than indexing numpy
    arrays one element at a time)."""
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:
            cur = (line + prev) & 255
        elif kind in (3, 4):
            cur, up = line.tolist(), prev.tolist()
            for x in range(row_bytes):
                b = up[x]
                a, c = (cur[x - bpp], up[x - bpp]) if x >= bpp else (0, 0)
                if kind == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 255
                    continue
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path):
    """A PNG of 8-bit grey, grey + alpha, RGB or RGBA samples, not
    interlaced, as uint8 [H, W, C] (C = 1, 2, 3 or 4): the PNG reader of
    the port, which reads what ``write_png`` writes without an imaging
    package (the card's machine has none).

    :raises ValueError: on another PNG (16-bit, palette, interlaced)
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color_type, _, _, interlace = ihdr
    c = _PNG_CHANNELS.get(color_type)
    if depth != 8 or c is None or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type "
                         f"{color_type}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw.reshape(h, 1 + w * c), h, w * c, c)
    return rows.reshape(h, w, c)
