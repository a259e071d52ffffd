"""First-party OpenEXR scanline *writer* (pure Python/numpy).

The port's copy of ``realtime_style_transfer_tpu/data/exr.py``.  The original
TensorFlow project ships no EXR writer (it reads Unreal's dumps through
pyroexr); the port needs one to fabricate G-buffer sets (``chip_smoke.py``,
the tests) instead of shipping engine dumps, and the writer round-trip-proves
the native C++ decoder (``native/exr_decoder.cpp``).

Format support mirrors the decoder exactly: single-part scanline EXR 2.0,
INCREASING_Y, compressions NONE/RLE/ZIPS/ZIP/PIZ, pixel types HALF/FLOAT.  The
RLE/ZIP pre-filter is OpenEXR's split-halves byte interleave followed by a
+128 delta predictor (see ``exr_decoder.cpp:exr_reorder`` for the inverse);
PIZ is the full spec'd bitmap-LUT + 2D wavelet + canonical-Huffman pipeline
(decoder twin: ``exr_decoder.cpp:piz_uncompress``).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

PIXEL_TYPE_UINT = 0
PIXEL_TYPE_HALF = 1
PIXEL_TYPE_FLOAT = 2

_COMPRESSION_CODES = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4}
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}

MAGIC = 20000630
VERSION = 2


def _attr(name: str, type_name: str, value: bytes) -> bytes:
    return (
        name.encode() + b"\0" + type_name.encode() + b"\0"
        + struct.pack("<i", len(value)) + value
    )


def _chlist(names: Sequence[str], pixel_type: int) -> bytes:
    out = b""
    for name in names:
        out += (
            name.encode() + b"\0"
            + struct.pack("<i", pixel_type)
            + b"\0\0\0\0"            # pLinear + 3 reserved
            + struct.pack("<ii", 1, 1)  # x/y sampling
        )
    return out + b"\0"


def _prefilter(raw: bytes) -> bytes:
    """OpenEXR RLE/ZIP pre-filter: interleave-split halves, then delta+128."""
    a = np.frombuffer(raw, np.uint8)
    split = np.concatenate([a[0::2], a[1::2]]).astype(np.int16)
    enc = split.copy()
    enc[1:] = split[1:] - split[:-1] + 128
    return enc.astype(np.uint8).tobytes()


def _rle_encode(data: bytes) -> bytes:
    """EXR RLE: count>=0 -> repeat next byte count+1; count<0 -> -count literals."""
    out = bytearray()
    i, n = 0, len(data)
    lit_start = i
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            while lit_start < i:  # flush pending literals
                chunk = min(127, i - lit_start)
                out.append(256 - chunk)  # two's complement of -chunk
                out += data[lit_start:lit_start + chunk]
                lit_start += chunk
            out.append(run - 1)
            out.append(data[i])
            i += run
            lit_start = i
        else:
            i += run
    while lit_start < i:
        chunk = min(127, i - lit_start)
        out.append(256 - chunk)
        out += data[lit_start:lit_start + chunk]
        lit_start += chunk
    return bytes(out)


# ---------------------------------------------------------------------------
# PIZ encoder (wavelet + Huffman), per the OpenEXR 2.0 format spec.  The
# matching first-party decoder is native/exr_decoder.cpp:piz_uncompress; the
# two are independent implementations of the spec'd bitstream, round-trip
# proven in the tests of both packages.
# ---------------------------------------------------------------------------

_BITMAP_SIZE = 8192
_HUF_ENCSIZE = (1 << 16) + 1   # data symbols + the iM run-length pseudo-symbol
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN


def _wenc14(a: np.ndarray, b: np.ndarray):
    """14-bit wavelet step: (a, b) -> (mean, diff), exact int semantics."""
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    ms = (as_ + bs) >> 1
    ds = as_ - bs
    return ms.astype(np.uint16), ds.astype(np.uint16)


def _wenc16(a: np.ndarray, b: np.ndarray):
    """16-bit modulo wavelet step (used when maxValue >= 2^14)."""
    ao = (a.astype(np.int32) + 0x8000) & 0xFFFF
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + 0x8000) & 0xFFFF, m)
    return m.astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wav2_encode(arr: np.ndarray, max_value: int) -> None:
    """2D wavelet forward transform in place on a (ny, nx) uint16 array."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    ny, nx = arr.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        ys = np.arange(0, max(ny - p2 + 1, 0), p2)
        xs = np.arange(0, max(nx - p2 + 1, 0), p2)
        if len(ys) and len(xs):
            i00, i01 = enc(arr[np.ix_(ys, xs)], arr[np.ix_(ys, xs + p)])
            i10, i11 = enc(arr[np.ix_(ys + p, xs)], arr[np.ix_(ys + p, xs + p)])
            o00, o10 = enc(i00, i10)
            o01, o11 = enc(i01, i11)
            arr[np.ix_(ys, xs)] = o00
            arr[np.ix_(ys + p, xs)] = o10
            arr[np.ix_(ys, xs + p)] = o01
            arr[np.ix_(ys + p, xs + p)] = o11
        if (nx & p) and len(ys):          # odd remainder column: vertical 1D
            x_last = len(xs) * p2
            l, h = enc(arr[ys, x_last], arr[ys + p, x_last])
            arr[ys, x_last] = l
            arr[ys + p, x_last] = h
        if (ny & p) and len(xs):          # odd remainder row: horizontal 1D
            y_last = len(ys) * p2
            l, h = enc(arr[y_last, xs], arr[y_last, xs + p])
            arr[y_last, xs] = l
            arr[y_last, xs + p] = h
        p = p2
        p2 <<= 1


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def put(self, nbits: int, value: int) -> None:
        self.c = (self.c << nbits) | (value & ((1 << nbits) - 1))
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)
        self.c &= (1 << self.lc) - 1

    def flush(self) -> bytes:
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.c, self.lc = 0, 0
        return bytes(self.out)

    @property
    def bit_count(self) -> int:
        return len(self.out) * 8 + self.lc


def _huf_code_lengths(freq: Dict[int, int]) -> Dict[int, int]:
    """Huffman code lengths (any optimal tree works — the bitstream carries
    the lengths; codes are derived canonically on both sides)."""
    import heapq

    items = sorted(freq.items())
    if len(items) == 1:
        return {items[0][0]: 1}
    lengths = {sym: 0 for sym, _ in items}
    heap = [(cnt, i, [sym]) for i, (sym, cnt) in enumerate(items)]
    heapq.heapify(heap)
    uid = len(items)
    while len(heap) > 1:
        c1, _, s1 = heapq.heappop(heap)
        c2, _, s2 = heapq.heappop(heap)
        for s in s1:
            lengths[s] += 1
        for s in s2:
            lengths[s] += 1
        heapq.heappush(heap, (c1 + c2, uid, s1 + s2))
        uid += 1
    assert max(lengths.values()) <= 58, "PIZ encoder: code length > 58"
    return lengths


def _huf_canonical_codes(lengths: Dict[int, int]) -> Dict[int, Tuple[int, int]]:
    """Length -> numerically-increasing canonical codes, matching the
    decoder's assignment exactly (counted from length 58 downward)."""
    n = [0] * 59
    for l in lengths.values():
        n[l] += 1
    c = 0
    counter = [0] * 59
    for i in range(58, 0, -1):
        counter[i] = c
        c = (c + n[i]) >> 1
    codes = {}
    for sym in sorted(lengths):
        l = lengths[sym]
        if l > 0:
            codes[sym] = (counter[l], l)
            counter[l] += 1
    return codes


def _huf_pack_table(lengths: Dict[int, int], im: int, iM: int) -> bytes:
    """6-bit code lengths with short/long zero-run codes (im..iM)."""
    w = _BitWriter()
    i = im
    while i <= iM:
        l = lengths.get(i, 0)
        if l == 0:
            zerun = 1
            while i < iM and zerun < _LONGEST_LONG_RUN:
                if lengths.get(i + 1, 0) > 0:
                    break
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= _SHORTEST_LONG_RUN:
                    w.put(6, _LONG_ZEROCODE_RUN)
                    w.put(8, zerun - _SHORTEST_LONG_RUN)
                else:
                    w.put(6, _SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        w.put(6, l)
        i += 1
    return w.flush()


def _huf_compress(data: np.ndarray) -> bytes:
    """OpenEXR Huffman coding of a uint16 array (with the iM run symbol)."""
    symbols, counts = np.unique(data, return_counts=True)
    freq = {int(s): int(c) for s, c in zip(symbols, counts)}
    im = min(freq)
    iM = max(freq) + 1       # run-length pseudo-symbol
    freq[iM] = 1
    lengths = _huf_code_lengths(freq)
    codes = _huf_canonical_codes(lengths)
    table = _huf_pack_table(lengths, im, iM)

    w = _BitWriter()
    run_code, run_len = codes[iM]

    def send(sym: int, run: int) -> None:
        c, l = codes[sym]
        if l + run_len + 8 < l * run:
            w.put(l, c)
            w.put(run_len, run_code)
            w.put(8, run)
        else:
            for _ in range(run + 1):
                w.put(l, c)

    flat = data.reshape(-1)
    s = int(flat[0])
    cs = 0
    for v in flat[1:].tolist():
        if v == s and cs < 255:
            cs += 1
        else:
            send(s, cs)
            cs = 0
            s = v
    send(s, cs)
    nbits = w.bit_count
    stream = w.flush()
    return (
        struct.pack("<IIIII", im, iM, len(table), nbits, 0) + table + stream
    )


def _piz_compress_block(raw: bytes, num_channels: int, ushorts_per_value: int,
                        width: int, lines: int) -> bytes:
    """PIZ-compress one scanline block (uniform channel type, no subsampling).

    Stages per the spec: bitmap of occurring values -> forward LUT ->
    per-channel-component 2D wavelet -> Huffman; the chunk carries
    [minNonZero u16][maxNonZero u16][bitmap slice][huf length i32][huf data].
    """
    data = np.frombuffer(raw, "<u2").copy()
    per_chan = width * ushorts_per_value
    # scanline-interleaved -> channel-major planes
    view = data.reshape(lines, num_channels * per_chan)
    tmp = np.concatenate(
        [view[:, c * per_chan:(c + 1) * per_chan].reshape(-1)
         for c in range(num_channels)])

    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    present = np.unique(tmp)
    np.bitwise_or.at(bitmap, present >> 3,
                     np.left_shift(1, (present & 7)).astype(np.uint8))
    bitmap[0] &= 0xFE  # zero is implicit, never stored in the bitmap
    nonzero = np.nonzero(bitmap)[0]
    if len(nonzero):
        min_nz, max_nz = int(nonzero[0]), int(nonzero[-1])
        bitmap_bytes = bitmap[min_nz:max_nz + 1].tobytes()
    else:
        min_nz, max_nz = _BITMAP_SIZE - 1, 0
        bitmap_bytes = b""

    # forward LUT: original value -> compressed index
    is_present = np.zeros(1 << 16, bool)
    is_present[0] = True
    is_present[present[present != 0]] = True
    lut = np.cumsum(is_present).astype(np.uint16) - 1
    max_value = int(lut[is_present.nonzero()[0][-1]])
    tmp = lut[tmp]

    for c in range(num_channels):
        base = c * per_chan * lines
        block = tmp[base:base + per_chan * lines].reshape(
            lines, width, ushorts_per_value)
        for j in range(ushorts_per_value):
            comp = block[:, :, j].copy()
            _wav2_encode(comp, max_value)
            block[:, :, j] = comp

    huf = _huf_compress(tmp)
    return (struct.pack("<HH", min_nz, max_nz) + bitmap_bytes
            + struct.pack("<i", len(huf)) + huf)


def _compress_block(raw: bytes, code: int, num_channels: int = 1,
                    ushorts_per_value: int = 2, width: int = 0,
                    lines: int = 0) -> bytes:
    """Compress one scanline block; store raw when it doesn't shrink.

    The stored-raw fallback is signalled by ``len == raw`` exactly as the
    decoder expects (``exr_decoder.cpp:decode_block``).
    """
    if code == 0:
        return raw
    if code == 4:
        packed = _piz_compress_block(
            raw, num_channels, ushorts_per_value, width, lines)
        return packed if len(packed) < len(raw) else raw
    filtered = _prefilter(raw)
    if code == 1:
        packed = _rle_encode(filtered)
    else:
        packed = zlib.compress(filtered)
    return packed if len(packed) < len(raw) else raw


def write_exr(
    path,
    channels: Mapping[str, np.ndarray],
    *,
    compression: str = "zip",
    pixel_type: int = PIXEL_TYPE_FLOAT,
) -> Path:
    """Write (h, w) float arrays as a scanline EXR the native decoder reads.

    Channels are stored in alphabetical order (the OpenEXR chlist contract);
    HALF data round-trips through float16.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if compression not in _COMPRESSION_CODES:
        raise ValueError(
            f"compression must be one of {sorted(_COMPRESSION_CODES)}"
        )
    if pixel_type not in (PIXEL_TYPE_HALF, PIXEL_TYPE_FLOAT):
        raise ValueError("writer supports HALF and FLOAT pixel types")
    code = _COMPRESSION_CODES[compression]
    names = sorted(channels)
    if not names:
        raise ValueError("need at least one channel")
    arrays = [np.asarray(channels[n], np.float32) for n in names]
    h, w = arrays[0].shape
    for name, arr in zip(names, arrays):
        if arr.shape != (h, w):
            raise ValueError(f"channel {name}: shape {arr.shape} != {(h, w)}")
    if pixel_type == PIXEL_TYPE_HALF:
        planes = [a.astype(np.float16) for a in arrays]
    else:
        planes = arrays

    header = struct.pack("<II", MAGIC, VERSION)
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("channels", "chlist", _chlist(names, pixel_type))
    header += _attr("compression", "compression", bytes([code]))
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")  # INCREASING_Y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    lpb = _LINES_PER_BLOCK[code]
    num_blocks = (h + lpb - 1) // lpb

    chunks = []
    for b in range(num_blocks):
        y0 = b * lpb
        lines = min(lpb, h - y0)
        # block layout: per scanline, per channel (file order), width values
        raw = b"".join(
            plane[y].tobytes()
            for y in range(y0, y0 + lines)
            for plane in planes
        )
        data = _compress_block(
            raw, code, num_channels=len(planes),
            ushorts_per_value=1 if pixel_type == PIXEL_TYPE_HALF else 2,
            width=w, lines=lines)
        chunks.append(struct.pack("<ii", y0, len(data)) + data)

    offset = len(header) + 8 * num_blocks
    table = b""
    for chunk in chunks:
        table += struct.pack("<Q", offset)
        offset += len(chunk)

    with open(path, "wb") as f:
        f.write(header)
        f.write(table)
        for chunk in chunks:
            f.write(chunk)
    return path


def write_gbuffer_fixture(
    directory,
    stem: str,
    channels: Sequence[Tuple[str, int]],
    height: int,
    width: int,
    *,
    seed: int = 0,
    compression: str = "zip",
) -> Path:
    """Fabricate one Unreal-style screenshot set: ``<stem>.png`` + EXR siblings.

    Follows the engine dump convention the loaders expect
    (``hdrScreenshots.py:14-29``): for each configured channel group an EXR
    named ``<stem>_<Channel>.exr`` with R[,G,B] planes; the base PNG carries
    the FinalImage (the training ground truth).  Returns the PNG path.
    """
    import PIL.Image

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    final_rgb: Optional[np.ndarray] = None
    for name, count in channels:
        data: Dict[str, np.ndarray] = {}
        plane_names = ("R", "G", "B")[:count] if count <= 3 else tuple(
            f"C{i}" for i in range(count)
        )
        for plane in plane_names:
            data[plane] = rng.random((height, width), np.float32).astype(
                np.float32
            )
        write_exr(
            directory / f"{stem}_{name}.exr", data, compression=compression
        )
        if name == "FinalImage" and count == 3:
            final_rgb = np.stack([data["R"], data["G"], data["B"]], axis=-1)
    if final_rgb is None:
        final_rgb = rng.random((height, width, 3), np.float32)
    png_path = directory / f"{stem}.png"
    PIL.Image.fromarray(
        (np.clip(final_rgb, 0.0, 1.0) * 255).astype(np.uint8)
    ).save(png_path)
    return png_path
