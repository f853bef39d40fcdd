"""FITS reader and writer, no astropy (imsim_tpu/io/fits.py
counterpart, the same bytes): primary and image extensions with
BSCALE/BZERO, binary tables (fixed and variable-length columns), RICE_1
tile-compressed int32 images (io/rice.py), gzip.

The visit driver writes the eimage, the raw amp file and the OPD and sag
outputs through `write_fits`; FITS-stamp objects and a measured skyline
surface read their images through `read_fits`.  A header card's text is
`_format_value`'s, so the files are byte-equal to the JAX package's.
"""
from __future__ import annotations

import gzip
import io
import os
import re

import numpy as np

BLOCK = 2880


def _format_value(v):
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        s = f"{float(v):.16G}"
        if "." not in s and "E" not in s and "INF" not in s and "NAN" not in s:
            s += "."
        return s
    # string
    s = str(v).replace("'", "''")
    return f"'{s:<8s}'"


def _card(key, value=None, comment=None):
    key = key.upper()[:8]
    if key in ("COMMENT", "HISTORY", ""):
        text = f"{key:<8s}{str(value or ''):<72s}"[:80]
        return text.ljust(80)
    vs = _format_value(value)
    if vs.startswith("'"):
        body = f"{key:<8s}= {vs:<20s}"
    else:
        body = f"{key:<8s}= {vs:>20s}"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80)


def _header_bytes(cards):
    text = "".join(cards) + "END".ljust(80)
    pad = (-len(text)) % BLOCK
    return (text + " " * pad).encode("ascii")


_BITPIX = {
    np.dtype(">u1"): 8, np.dtype(">i2"): 16, np.dtype(">i4"): 32,
    np.dtype(">i8"): 64, np.dtype(">f4"): -32, np.dtype(">f8"): -64,
}


class HDU:
    """One header-data unit: dict-like header + ndarray or None."""

    def __init__(self, data=None, header=None, name=None, is_primary=False,
                 compress=None):
        self.data = data
        self.header = dict(header or {})
        self.name = name
        self.is_primary = is_primary
        self.compress = compress  # None | 'rice'


def _serialize_image_hdu(hdu: HDU, primary: bool) -> bytes:
    data = hdu.data
    cards = []
    if data is None:
        if primary:
            cards.append(_card("SIMPLE", True, "conforms to FITS standard"))
            cards.append(_card("BITPIX", 8))
            cards.append(_card("NAXIS", 0))
            cards.append(_card("EXTEND", True))
        else:
            cards.append(_card("XTENSION", "IMAGE", "Image extension"))
            cards.append(_card("BITPIX", 8))
            cards.append(_card("NAXIS", 0))
            cards.append(_card("PCOUNT", 0))
            cards.append(_card("GCOUNT", 1))
        for k, v in hdu.header.items():
            cards.append(_card(k, v))
        return _header_bytes(cards)

    data = np.asarray(data)
    # Integer data with unsigned range uses BZERO convention
    bzero = 0
    if data.dtype == np.uint16:
        data = (data.astype(np.int32) - 32768).astype(np.int16)
        bzero = 32768
    elif data.dtype == np.uint32:
        data = (data.astype(np.int64) - 2147483648).astype(np.int32)
        bzero = 2147483648
    be = data.astype(data.dtype.newbyteorder(">"))
    bitpix = _BITPIX[be.dtype]
    if primary:
        cards = [_card("SIMPLE", True, "conforms to FITS standard"),
                 _card("BITPIX", bitpix),
                 _card("NAXIS", data.ndim)]
    else:
        cards = [_card("XTENSION", "IMAGE", "Image extension"),
                 _card("BITPIX", bitpix),
                 _card("NAXIS", data.ndim)]
    for i, n in enumerate(reversed(data.shape)):
        cards.append(_card(f"NAXIS{i + 1}", n))
    if not primary:
        cards.append(_card("PCOUNT", 0))
        cards.append(_card("GCOUNT", 1))
    if primary:
        cards.append(_card("EXTEND", True))
    if bzero:
        cards.append(_card("BZERO", bzero))
        cards.append(_card("BSCALE", 1))
    if hdu.name:
        cards.append(_card("EXTNAME", hdu.name))
    for k, v in hdu.header.items():
        cards.append(_card(k, v))
    payload = be.tobytes()
    pad = (-len(payload)) % BLOCK
    return _header_bytes(cards) + payload + b"\0" * pad


def write_fits(path, hdus, overwrite=True):
    """hdus: HDU list, or a bare ndarray (single image file)."""
    if isinstance(hdus, np.ndarray):
        hdus = [HDU(hdus)]
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    buf = io.BytesIO()
    for i, hdu in enumerate(hdus):
        if isinstance(hdu, BinTableHDU):
            if i == 0:
                buf.write(_serialize_image_hdu(HDU(None), primary=True))
            buf.write(_serialize_bintable_hdu(hdu))
        elif hdu.compress == "rice" and hdu.data is not None and i > 0:
            from .rice import serialize_rice_hdu
            buf.write(serialize_rice_hdu(hdu))
        else:
            buf.write(_serialize_image_hdu(hdu, primary=(i == 0)))
    raw = buf.getvalue()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=6) as f:
            f.write(raw)
    else:
        with open(path, "wb") as f:
            f.write(raw)

_TFORM_SCALAR = {"L": ">u1", "B": ">u1", "I": ">i2", "J": ">i4",
                 "K": ">i8", "E": ">f4", "D": ">f8"}
_NP_TO_TFORM = {"u1": "B", "i2": "I", "i4": "J", "i8": "K",
                "f4": "E", "f8": "D"}
_DTYPES = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}


def _parse_tform(tform: str):
    """-> (repeat, 'P'|'Q'|'', type letter)."""
    m = re.match(r"^(\d*)([PQ]?)([LXBIJKAEDCM])", tform.strip())
    if not m:
        raise ValueError(f"unsupported TFORM {tform!r}")
    return (int(m.group(1)) if m.group(1) else 1, m.group(2), m.group(3))


def read_bintable(header: dict, payload: bytes) -> dict:
    """A BINTABLE payload as {column_name: data}: scalar columns as (nrow,)
    or (nrow, repeat) arrays, 'A' columns as lists of strings,
    variable-length 'P<t>()' / 'Q<t>()' columns as lists of per-row arrays
    read from the heap."""
    nrow = int(header["NAXIS2"])
    rowlen = int(header["NAXIS1"])
    theap = int(header.get("THEAP", nrow * rowlen))
    heap = payload[theap:]
    rows = np.frombuffer(payload[:nrow * rowlen],
                         np.uint8).reshape(nrow, rowlen)
    out = {}
    off = 0
    for i in range(1, int(header["TFIELDS"]) + 1):
        rep, var, letter = _parse_tform(str(header[f"TFORM{i}"]))
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        if var == "P":
            desc = rows[:, off:off + rep * 8]
            dv = np.frombuffer(desc.tobytes(), ">i4").reshape(nrow, 2)
            dt = np.dtype(_TFORM_SCALAR[letter])
            out[name] = [np.frombuffer(
                heap[o:o + c * dt.itemsize], dt).astype(dt.newbyteorder())
                for c, o in dv]
            off += rep * 8
        elif var == "Q":
            desc = rows[:, off:off + rep * 16]
            dv = np.frombuffer(desc.tobytes(), ">i8").reshape(nrow, 2)
            dt = np.dtype(_TFORM_SCALAR[letter])
            out[name] = [np.frombuffer(
                heap[o:o + c * dt.itemsize], dt).astype(dt.newbyteorder())
                for c, o in dv]
            off += rep * 16
        elif letter == "A":
            w = rep
            raw = rows[:, off:off + w].tobytes()
            out[name] = [raw[r * w:(r + 1) * w].decode("ascii").rstrip()
                         for r in range(nrow)]
            off += w
        else:
            dt = np.dtype(_TFORM_SCALAR[letter])
            w = rep * dt.itemsize
            a = np.frombuffer(rows[:, off:off + w].tobytes(), dt)
            a = a.astype(dt.newbyteorder())
            out[name] = a if rep == 1 else a.reshape(nrow, rep)
            off += w
    return out


class BinTableHDU:
    """Binary-table HDU for write_fits: columns is an ordered dict
    {name: (nrow,) array | (nrow, rep) array | list of 1-D arrays
    (variable length, stored as P descriptors + heap)}."""

    def __init__(self, columns: dict, name=None, header=None):
        self.columns = dict(columns)
        self.name = name
        self.header = dict(header or {})
        self.is_primary = False
        self.compress = None
        self.data = None


def _serialize_bintable_hdu(hdu: BinTableHDU) -> bytes:
    names = list(hdu.columns)
    nrow = None
    specs = []            # (name, tform, cell bytes function)
    heap = bytearray()
    cells = []
    for name in names:
        col = hdu.columns[name]
        if isinstance(col, list):      # variable-length
            nrow = len(col) if nrow is None else nrow
            base = np.asarray(col[0]).dtype if col else np.dtype("i4")
            letter = _NP_TO_TFORM[base.str[1:]]
            desc = np.empty((nrow, 2), ">i4")
            for r, a in enumerate(col):
                a = np.ascontiguousarray(np.asarray(a),
                                         dtype=base.newbyteorder(">"))
                desc[r] = (len(a), len(heap))
                heap += a.tobytes()
            specs.append((name, f"P{letter}()"))
            cells.append(desc.view(np.uint8).reshape(nrow, 8))
        else:
            a = np.asarray(col)
            nrow = a.shape[0] if nrow is None else nrow
            if a.dtype.kind == "U" or a.dtype.kind == "S":
                w = int(str(a.dtype)[2:]) if a.dtype.kind == "S" \
                    else max(len(s) for s in a)
                b = np.array([s.encode("ascii").ljust(w)[:w]
                              for s in a.astype(str)])
                specs.append((name, f"{w}A"))
                cells.append(np.frombuffer(b.tobytes(),
                                           np.uint8).reshape(nrow, w))
            else:
                be = a.astype(a.dtype.newbyteorder(">"))
                letter = _NP_TO_TFORM[a.dtype.str[1:]]
                rep = 1 if a.ndim == 1 else a.shape[1]
                specs.append((name, f"{rep}{letter}"))
                cells.append(be.view(np.uint8).reshape(nrow, -1))
    rowlen = sum(c.shape[1] for c in cells)
    table = np.concatenate(cells, axis=1)
    payload = table.tobytes() + bytes(heap)
    cards = [_card("XTENSION", "BINTABLE", "binary table extension"),
             _card("BITPIX", 8), _card("NAXIS", 2),
             _card("NAXIS1", rowlen), _card("NAXIS2", nrow),
             _card("PCOUNT", len(heap)), _card("GCOUNT", 1),
             _card("TFIELDS", len(names))]
    for i, (name, tform) in enumerate(specs, start=1):
        cards.append(_card(f"TTYPE{i}", name))
        cards.append(_card(f"TFORM{i}", tform))
    if hdu.name:
        cards.append(_card("EXTNAME", hdu.name))
    for k, v in hdu.header.items():
        cards.append(_card(k, v))
    pad = (-len(payload)) % BLOCK
    return _header_bytes(cards) + payload + b"\0" * pad


def read_fits(path):
    """Return a list of (header_dict, ndarray-or-None); a binary table's
    data is its raw bytes (read_bintable parses them), a RICE-compressed
    image's its decoded int32 array."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    out = []
    offset = 0
    while offset < len(raw):
        hdr_end = offset
        cards = {}
        while True:
            text = raw[hdr_end:hdr_end + BLOCK].decode("ascii", "replace")
            hdr_end += BLOCK
            stop = False
            for i in range(0, len(text), 80):
                card = text[i:i + 80]
                key = card[:8].strip()
                if key == "END":
                    stop = True
                    break
                if card[8:10] != "= ":
                    continue
                val = card[10:].split("/")[0].strip()
                if val.startswith("'"):
                    v = val[1:]
                    v = v[: v.index("'")].rstrip() if "'" in v else v
                elif val == "T":
                    v = True
                elif val == "F":
                    v = False
                else:
                    try:
                        v = int(val)
                    except ValueError:
                        try:
                            v = float(val)
                        except ValueError:
                            v = val
                cards[key] = v
            if stop:
                break
        naxis = cards.get("NAXIS", 0)
        shape = tuple(cards[f"NAXIS{naxis - i}"] for i in range(naxis))
        nelem = int(np.prod(shape)) if shape else 0
        pcount = cards.get("PCOUNT", 0)
        data = None
        nbytes = 0
        if cards.get("XTENSION", "").startswith("BINTABLE"):
            nbytes = cards["NAXIS1"] * cards["NAXIS2"] + pcount
            if cards.get("ZIMAGE") and cards.get("ZCMPTYPE",
                                                 "").startswith("RICE"):
                from .rice import deserialize_rice_hdu
                data = deserialize_rice_hdu(
                    cards, raw[hdr_end:hdr_end + nbytes])
            else:
                data = raw[hdr_end:hdr_end + nbytes]  # opaque table bytes
        elif nelem:
            dt = np.dtype(_DTYPES[cards["BITPIX"]])
            nbytes = nelem * dt.itemsize + pcount
            data = np.frombuffer(raw[hdr_end:hdr_end + nelem * dt.itemsize],
                                 dtype=dt).reshape(shape)
            if cards.get("BZERO") or cards.get("BSCALE", 1) != 1:
                data = data.astype(np.float64) * cards.get("BSCALE", 1) \
                    + cards.get("BZERO", 0)
                if cards.get("BZERO") in (32768, 2147483648) \
                        and cards.get("BSCALE", 1) == 1:
                    data = data.astype(np.uint16 if cards["BZERO"] == 32768
                                       else np.uint32)
        out.append((cards, data))
        offset = hdr_end + nbytes + ((-nbytes) % BLOCK)
    return out
