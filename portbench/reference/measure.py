"""Reading back what the program produced, with plain numpy: FITS images
and RICE_1 tile-compressed amps, the truth catalog, and the centroids
of isolated stars in a charge image."""
from __future__ import annotations

import numpy as np

_BLOCK = 2880


def _cards(buf: bytes, pos: int):
    """(header dict, offset after the header) of the HDU at pos."""
    cards = {}
    while True:
        block = buf[pos:pos + _BLOCK]
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        pos += _BLOCK
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode("ascii")
            key = card[:8].strip()
            if key == "END":
                return cards, pos
            if card[8:10] == "= ":
                val = card[10:].split("/")[0].strip()
                if val.startswith("'"):
                    cards[key] = card[10:].strip().split("'")[1].rstrip()
                elif val in ("T", "F"):
                    cards[key] = val == "T"
                else:
                    try:
                        cards[key] = int(val)
                    except ValueError:
                        cards[key] = float(val)


def read_fits(path: str) -> list:
    """[(header dict, payload bytes)] of every HDU."""
    with open(path, "rb") as f:
        buf = f.read()
    out, pos = [], 0
    while pos < len(buf):
        cards, pos = _cards(buf, pos)
        n = abs(int(cards.get("BITPIX", 8))) // 8
        naxis = int(cards.get("NAXIS", 0))
        size = 0
        if naxis:
            size = n
            for k in range(1, naxis + 1):
                size *= int(cards[f"NAXIS{k}"])
        size += int(cards.get("PCOUNT", 0))
        out.append((cards, buf[pos:pos + size]))
        pos += -(-size // _BLOCK) * _BLOCK
    return out


def image(cards: dict, payload: bytes) -> np.ndarray:
    """A plain image HDU's array (BITPIX -32, -64, 16 or 32)."""
    dt = {-32: ">f4", -64: ">f8", 16: ">i2", 32: ">i4"}[int(cards["BITPIX"])]
    shape = (int(cards["NAXIS2"]), int(cards["NAXIS1"]))
    return np.frombuffer(payload, dt, count=shape[0] * shape[1]).reshape(
        shape)


def rice_decode(buf: bytes, n: int, blocksize: int = 32) -> np.ndarray:
    """One RICE_1 tile of n int32 pixels (FITS 4.0, Rice compression:
    the first pixel in 32 bits big-endian, then blocks of a 5-bit code
    fs+1, with 0 for a block of repeats and 26 for raw 32-bit values,
    else per pixel a unary high part and fs low bits of the zigzagged
    difference)."""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8)).tobytes()
    bits = bits.replace(b"\x01", b"1").replace(b"\x00", b"0")
    last = int(bits[:32], 2)
    if last >= 1 << 31:
        last -= 1 << 32
    pos = 32
    out = np.empty(n, np.int64)
    for start in range(0, n, blocksize):
        m = min(blocksize, n - start)
        fs = int(bits[pos:pos + 5], 2) - 1
        pos += 5
        if fs < 0:
            out[start:start + m] = last
            continue
        for i in range(m):
            if fs == 25:
                mv = int(bits[pos:pos + 32], 2)
                pos += 32
            else:
                one = bits.index(b"1", pos)
                mv = (one - pos) << fs
                pos = one + 1
                if fs:
                    mv |= int(bits[pos:pos + fs], 2)
                    pos += fs
            d = (mv >> 1) if not mv & 1 else -(mv >> 1) - 1
            last = ((last + d + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
            out[start + i] = last
    return out.astype(np.int32)


def rice_image(cards: dict, payload: bytes) -> np.ndarray:
    """A RICE_1 tile-compressed BINTABLE's int32 image (one tile a
    row, 1PB descriptors)."""
    nx, ny = int(cards["ZNAXIS1"]), int(cards["ZNAXIS2"])
    if int(cards.get("ZTILE2", 1)) != 1 or int(cards.get("ZTILE1", nx)) != nx:
        raise ValueError("only row tiles are read")
    nrow = int(cards["NAXIS2"])
    width = int(cards["NAXIS1"])
    desc = np.frombuffer(payload[:width * nrow], ">i4").reshape(nrow, 2)
    heap = payload[width * nrow:]
    block = 32
    if cards.get("ZNAME1") == "BLOCKSIZE":
        block = int(cards["ZVAL1"])
    img = np.empty((ny, nx), np.int32)
    for y in range(ny):
        nb, off = int(desc[y, 0]), int(desc[y, 1])
        img[y] = rice_decode(heap[off:off + nb], nx, block)
    return img


def read_truth(path: str) -> dict:
    """The truth catalog: object_id ra dec x y nominal_flux phot_flux
    fft_flux realized_flux mode, one array a column."""
    with open(path) as f:
        names = f.readline().lstrip("#").split()
        rows = [line.split() for line in f if line.strip()]
    cols = list(zip(*rows)) if rows else [[] for _ in names]
    out = {}
    for name, col in zip(names, cols):
        if name == "object_id":
            out[name] = np.array(col, dtype=np.int64)
        else:
            out[name] = np.array(col, dtype=float)
    return out


def centroids(img: np.ndarray, x0, y0, half: int = 6, sigma: float = 2.0,
              niter: int = 4):
    """Gaussian-weighted first moments of `img` (y, x) around (x0, y0),
    recentred niter times: (x, y).  Pixel (i, j) is centred at x = j,
    y = i (the program's pixel convention)."""
    x = np.asarray(x0, float).copy()
    y = np.asarray(y0, float).copy()
    ny, nx = img.shape
    k = np.arange(-half, half + 1)
    for _ in range(niter):
        # a window without charge gives NaN, which stays NaN
        cx = np.clip(np.round(np.nan_to_num(x)).astype(int), half,
                     nx - half - 1)
        cy = np.clip(np.round(np.nan_to_num(y)).astype(int), half,
                     ny - half - 1)
        sub = img[cy[:, None, None] + k[None, :, None],
                  cx[:, None, None] + k[None, None, :]].astype(np.float64)
        gx = cx[:, None, None] + k[None, None, :]
        gy = cy[:, None, None] + k[None, :, None]
        w = np.exp(-0.5 * ((gx - x[:, None, None]) ** 2
                           + (gy - y[:, None, None]) ** 2) / sigma ** 2)
        s = (sub * w).sum(axis=(1, 2))
        s = np.where(s > 0, s, np.nan)
        x = (sub * w * gx).sum(axis=(1, 2)) / s
        y = (sub * w * gy).sum(axis=(1, 2)) / s
    return x, y
