"""FITS reader, no astropy (the reader half of imsim_tpu/io/fits.py):
primary and image extensions with BSCALE/BZERO, binary tables, gzip.

FITS-stamp objects (`image/scene._fits_point_cloud`) and a measured
skyline surface read their images through `read_fits`.  A RICE tile-
compressed HDU raises NotImplementedError: the codec comes with the FITS
writers (ROADMAP A6).
"""
from __future__ import annotations

import gzip
import re

import numpy as np

BLOCK = 2880

_TFORM_SCALAR = {"L": ">u1", "B": ">u1", "I": ">i2", "J": ">i4",
                 "K": ">i8", "E": ">f4", "D": ">f8"}
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


def read_fits(path):
    """Return a list of (header_dict, ndarray-or-None); a binary table's
    data is its raw bytes (read_bintable parses them)."""
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
                raise NotImplementedError(
                    f"{path}: a RICE-compressed HDU; the RICE codec comes "
                    f"with the FITS writers (ROADMAP A6)")
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
