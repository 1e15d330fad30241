"""Minimal self-contained FITS image reader/writer (no astropy dependency).

Batched replacement for the reference's Cfitsio-based FITS layer
(ref: SKIRTcore/FITSInOut.cpp:32,95 and SKIRTcore/Image.cpp:174,277-301):
writes 2-D frames and 3-D spectral cubes with the same WCS-ish keywords the
reference emits, reads simple single-HDU images for kernels/reference maps.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880
_CARD = 80


def _card(key: str, value, comment: str = "") -> bytes:
    if value is None:
        text = f"{key:<8}"
    elif isinstance(value, bool):
        text = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, int):
        text = f"{key:<8}= {value:>20}"
    elif isinstance(value, float):
        text = f"{key:<8}= {value:>20.14E}"
    else:
        text = f"{key:<8}= '{str(value):<8}'"
    if comment:
        text += f" / {comment}"
    return text[:_CARD].ljust(_CARD).encode("ascii")


def write_fits(path: str, data: np.ndarray, *,
               incx: float = 1.0, incy: float = 1.0,
               xc: float = 0.0, yc: float = 0.0,
               units: str = "", extra_cards: dict | None = None) -> None:
    """Write a 2-D image (ny,nx) or 3-D cube (nframes,ny,nx) as float64 FITS.

    Matches the reference's axis order and keywords (ref: SKIRTcore/FITSInOut.cpp
    Write: CRPIX at center, CRVAL xc/yc, CDELT incx/incy).
    """
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 2:
        naxis = [data.shape[1], data.shape[0]]
    elif data.ndim == 3:
        naxis = [data.shape[2], data.shape[1], data.shape[0]]
    else:
        raise ValueError("FITS writer supports 2-D or 3-D arrays")

    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", -64),
        _card("NAXIS", len(naxis)),
    ]
    for i, n in enumerate(naxis):
        cards.append(_card(f"NAXIS{i+1}", int(n)))
    cards += [
        _card("CRPIX1", (naxis[0] + 1) / 2.0, "X of reference pixel"),
        _card("CRVAL1", float(xc), "coordinate at X reference pixel"),
        _card("CDELT1", float(incx), "coordinate increment along X"),
        _card("CRPIX2", (naxis[1] + 1) / 2.0, "Y of reference pixel"),
        _card("CRVAL2", float(yc), "coordinate at Y reference pixel"),
        _card("CDELT2", float(incy), "coordinate increment along Y"),
    ]
    if units:
        cards.append(_card("BUNIT", units, "physical unit of array values"))
    for key, val in (extra_cards or {}).items():
        cards.append(_card(key, val))
    cards.append(b"END".ljust(_CARD))

    header = b"".join(cards)
    header += b" " * (-len(header) % _BLOCK)

    payload = data.astype(">f8").tobytes()
    payload += b"\0" * (-len(payload) % _BLOCK)

    with open(path, "wb") as f:
        f.write(header)
        f.write(payload)


def read_fits(path: str) -> tuple[np.ndarray, dict]:
    """Read the primary HDU of a simple FITS file -> (data, header dict)."""
    with open(path, "rb") as f:
        raw = f.read()

    header: dict = {}
    offset = 0
    done = False
    while not done:
        block = raw[offset:offset + _BLOCK]
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        for i in range(0, _BLOCK, _CARD):
            card = block[i:i + _CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" not in card:
                continue
            raw_value = card[9:]
            stripped = raw_value.strip()
            if stripped.startswith("'"):
                # quoted string: take content up to the closing quote
                # (slashes inside quotes are part of the value, not a comment)
                end = stripped.find("'", 1)
                header[key] = stripped[1:end if end > 0 else None].strip()
                continue
            value = raw_value.split("/")[0].strip()
            if value in ("T", "F"):
                header[key] = value == "T"
            else:
                try:
                    header[key] = int(value)
                except ValueError:
                    try:
                        header[key] = float(value)
                    except ValueError:
                        header[key] = value
        offset += _BLOCK

    bitpix = header["BITPIX"]
    naxis = header["NAXIS"]
    shape = [header[f"NAXIS{i+1}"] for i in range(naxis)][::-1]
    count = int(np.prod(shape)) if shape else 0
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
             -32: ">f4", -64: ">f8"}[bitpix]
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    data = data.reshape(shape).astype(np.float64)
    bscale = header.get("BSCALE", 1.0)
    bzero = header.get("BZERO", 0.0)
    if bscale != 1.0 or bzero != 0.0:
        data = data * bscale + bzero
    return data, header
