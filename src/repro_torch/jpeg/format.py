"""JFIF/JPEG container: marker segment writer and parser (baseline SOF0).

Host-side. The parser produces a :class:`JpegImage` with everything the
device decoder needs: frame geometry, per-component sampling/table ids, the
quantization and Huffman table *contents*, and the (still byte-stuffed)
entropy-coded scan payload.

This module is a copy of the JAX package's ``jpeg/format.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .tables import INV_ZIGZAG, ZIGZAG, HuffmanSpec

# Marker bytes (second byte; first is always 0xFF).
M_SOI = 0xD8
M_EOI = 0xD9
M_SOS = 0xDA
M_DQT = 0xDB
M_DHT = 0xC4
M_SOF0 = 0xC0
M_APP0 = 0xE0
M_DRI = 0xDD
M_COM = 0xFE
M_RST0 = 0xD0  # .. 0xD7


@dataclasses.dataclass
class ComponentInfo:
    comp_id: int          # component identifier (1=Y, 2=Cb, 3=Cr by convention)
    h: int                # horizontal sampling factor
    v: int                # vertical sampling factor
    quant_id: int         # quantization table selector
    dc_table: int = 0     # Huffman DC table selector (from SOS)
    ac_table: int = 0     # Huffman AC table selector (from SOS)


@dataclasses.dataclass
class JpegImage:
    """Parsed baseline JPEG."""

    width: int
    height: int
    components: List[ComponentInfo]
    quant_tables: Dict[int, np.ndarray]          # id -> (64,) natural order
    huffman_specs: Dict[Tuple[str, int], HuffmanSpec]  # ("dc"/"ac", id) -> spec
    scan_data: bytes                              # entropy-coded, byte-stuffed
    restart_interval: int = 0                     # MCUs between RST markers (0=off)
    truncated: bool = False                       # scan cut short (EOF before EOI)

    # --- Derived geometry -------------------------------------------------
    @property
    def h_max(self) -> int:
        return max(c.h for c in self.components)

    @property
    def v_max(self) -> int:
        return max(c.v for c in self.components)

    @property
    def mcu_width(self) -> int:
        return 8 * self.h_max

    @property
    def mcu_height(self) -> int:
        return 8 * self.v_max

    @property
    def mcus_x(self) -> int:
        return -(-self.width // self.mcu_width)

    @property
    def mcus_y(self) -> int:
        return -(-self.height // self.mcu_height)

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def units_per_mcu(self) -> int:
        return sum(c.h * c.v for c in self.components)

    @property
    def n_units(self) -> int:
        return self.n_mcus * self.units_per_mcu

    def comp_plane_shape(self, ci: int) -> Tuple[int, int]:
        """Padded (height, width) of component ci's sample plane."""
        c = self.components[ci]
        return (self.mcus_y * c.v * 8, self.mcus_x * c.h * 8)

    def unit_component(self) -> np.ndarray:
        """(units_per_mcu,) component index for each data unit within an MCU."""
        out = []
        for ci, c in enumerate(self.components):
            out.extend([ci] * (c.h * c.v))
        return np.array(out, dtype=np.int32)

    def subsampling_name(self) -> str:
        if len(self.components) == 1:
            return "gray"
        key = (self.components[0].h, self.components[0].v)
        return {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0"}.get(key, f"{key}")


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _seg(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def write_jpeg(
    width: int,
    height: int,
    components: List[ComponentInfo],
    quant_tables: Dict[int, np.ndarray],
    huffman_specs: Dict[Tuple[str, int], HuffmanSpec],
    scan_data: bytes,
    restart_interval: int = 0,
    comment: Optional[bytes] = None,
) -> bytes:
    """Assemble a complete baseline JFIF byte stream."""
    out = bytearray()
    out += bytes([0xFF, M_SOI])
    # APP0 / JFIF header
    app0 = b"JFIF\x00" + bytes([1, 2, 0]) + (1).to_bytes(2, "big") * 2 + bytes([0, 0])
    out += _seg(M_APP0, app0)
    if comment:
        out += _seg(M_COM, comment)
    # DQT segments (natural order in memory -> zig-zag order on the wire)
    for qid, q in sorted(quant_tables.items()):
        q = np.asarray(q).reshape(64)
        payload = bytes([qid & 0xF]) + bytes(int(q[ZIGZAG[k]]) for k in range(64))
        out += _seg(M_DQT, payload)
    # SOF0
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([len(components)])
    for c in components:
        sof += bytes([c.comp_id, (c.h << 4) | c.v, c.quant_id])
    out += _seg(M_SOF0, sof)
    # DHT segments
    for (kind, tid), spec in sorted(huffman_specs.items()):
        tc = 0 if kind == "dc" else 1
        payload = bytes([(tc << 4) | tid])
        payload += bytes(int(b) for b in spec.bits)
        payload += bytes(int(v) for v in spec.vals)
        out += _seg(M_DHT, payload)
    if restart_interval:
        out += _seg(M_DRI, restart_interval.to_bytes(2, "big"))
    # SOS
    sos = bytes([len(components)])
    for c in components:
        sos += bytes([c.comp_id, (c.dc_table << 4) | c.ac_table])
    sos += bytes([0, 63, 0])  # spectral selection + approximation (baseline)
    out += _seg(M_SOS, sos)
    out += scan_data
    out += bytes([0xFF, M_EOI])
    return bytes(out)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class JpegFormatError(ValueError):
    """Malformed JPEG container.

    Every parser raise carries uniform diagnostics: ``offset`` is the byte
    position in the blob at which the defect was detected, ``marker`` the
    marker code (second byte, e.g. 0xC4 for DHT) being parsed when it was
    — both ``None`` when genuinely unknowable. The validation layer
    (``core.bitstream.validate_batch``) surfaces them per image.
    """

    def __init__(self, message: str, offset: Optional[int] = None,
                 marker: Optional[int] = None):
        ctx = []
        if marker is not None:
            ctx.append(f"marker 0xFF{marker:02X}")
        if offset is not None:
            ctx.append(f"byte {offset}")
        super().__init__(message + (f" ({', '.join(ctx)})" if ctx else ""))
        self.offset = offset
        self.marker = marker


class JpegTruncationError(JpegFormatError):
    """The stream ended before it was complete (EOF before EOI).

    Raised for every truncation class: mid-marker, mid-segment-header,
    header segment overrunning the data, and — unless the caller opts into
    ``parse_jpeg(allow_truncated=True)`` — entropy-coded data with no
    terminating marker. Distinct from a plain :class:`JpegFormatError` so
    the resilience layer can tell "cut short" (a *prefix* may still
    decode) from "structurally wrong".
    """


def parse_jpeg(data: bytes, *, allow_truncated: bool = False) -> JpegImage:
    """Parse a baseline (SOF0) JFIF stream into a JpegImage.

    Strict by default: any structural defect raises
    :class:`JpegFormatError`, and any truncation — including entropy-coded
    data that ends before a terminating marker — raises the typed
    :class:`JpegTruncationError` (it used to fall through silently or
    surface as an ``IndexError``). With ``allow_truncated=True`` a stream
    whose *headers* are intact but whose entropy data is cut short returns
    the partial image with ``truncated=True`` instead of raising — the
    resilient-decode path uses this to recover the surviving restart
    segments. Header truncation always raises: there is nothing decodable
    without tables and geometry.
    """
    if len(data) < 4 or data[0] != 0xFF or data[1] != M_SOI:
        raise JpegFormatError("missing SOI", offset=0)
    pos = 2
    quant_tables: Dict[int, np.ndarray] = {}
    huffman_specs: Dict[Tuple[str, int], HuffmanSpec] = {}
    components: List[ComponentInfo] = []
    width = height = 0
    restart_interval = 0
    scan_data: Optional[bytes] = None
    truncated = False
    saw_eoi = False

    try:
        while pos < len(data):
            if data[pos] != 0xFF:
                raise JpegFormatError(
                    f"expected marker, got {data[pos]:#x}", offset=pos)
            if pos + 1 >= len(data):
                raise JpegTruncationError("stream ends mid-marker", offset=pos)
            marker = data[pos + 1]
            pos += 2
            if marker == M_EOI:
                saw_eoi = True
                break
            if marker == M_SOI or (M_RST0 <= marker <= M_RST0 + 7):
                continue  # parameterless
            if pos + 2 > len(data):
                raise JpegTruncationError(
                    "stream ends mid-segment-length", offset=pos, marker=marker)
            seg_len = int.from_bytes(data[pos : pos + 2], "big")
            if seg_len < 2:
                raise JpegFormatError(
                    f"segment length {seg_len} < 2", offset=pos, marker=marker)
            if pos + seg_len > len(data):
                raise JpegTruncationError(
                    f"segment length {seg_len} overruns end of data",
                    offset=pos, marker=marker)
            payload = data[pos + 2 : pos + seg_len]
            if marker == M_DQT:
                p = 0
                while p < len(payload):
                    pq, tq = payload[p] >> 4, payload[p] & 0xF
                    p += 1
                    if pq != 0:
                        raise JpegFormatError("16-bit quant tables unsupported",
                                              offset=pos + 1 + p, marker=marker)
                    if p + 64 > len(payload):
                        raise JpegFormatError(
                            f"DQT payload too short for table {tq} "
                            f"(need 64 bytes, have {len(payload) - p})",
                            offset=pos + 1 + p, marker=marker)
                    zz = np.frombuffer(payload[p : p + 64], dtype=np.uint8).astype(np.int32)
                    q = np.zeros(64, dtype=np.int32)
                    q[ZIGZAG[np.arange(64)]] = zz  # wire is zig-zag order
                    quant_tables[tq] = q
                    p += 64
            elif marker == M_DHT:
                p = 0
                while p < len(payload):
                    tc, th = payload[p] >> 4, payload[p] & 0xF
                    p += 1
                    if p + 16 > len(payload):
                        raise JpegFormatError(
                            f"DHT payload too short for the 16 code-length "
                            f"counts of table ({tc},{th})",
                            offset=pos + 1 + p, marker=marker)
                    bits = np.frombuffer(payload[p : p + 16], dtype=np.uint8).astype(np.int32)
                    p += 16
                    n = int(bits.sum())
                    if p + n > len(payload):
                        raise JpegFormatError(
                            f"DHT payload too short for {n} values of table "
                            f"({tc},{th}) (have {len(payload) - p})",
                            offset=pos + 1 + p, marker=marker)
                    vals = np.frombuffer(payload[p : p + n], dtype=np.uint8).astype(np.int32)
                    p += n
                    huffman_specs[("dc" if tc == 0 else "ac", th)] = HuffmanSpec(bits, vals)
            elif marker == M_SOF0:
                if len(payload) < 6:
                    raise JpegFormatError(
                        f"SOF0 payload too short ({len(payload)} bytes)",
                        offset=pos, marker=marker)
                height = int.from_bytes(payload[1:3], "big")
                width = int.from_bytes(payload[3:5], "big")
                ncomp = payload[5]
                if len(payload) < 6 + 3 * ncomp:
                    raise JpegFormatError(
                        f"SOF0 payload too short for {ncomp} components",
                        offset=pos, marker=marker)
                for i in range(ncomp):
                    cid, hv, tq = payload[6 + 3 * i : 9 + 3 * i]
                    components.append(ComponentInfo(cid, hv >> 4, hv & 0xF, tq))
            elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                            0xCD, 0xCE, 0xCF):
                raise JpegFormatError(
                    f"non-baseline SOF marker 0xFF{marker:02X} unsupported "
                    f"(baseline only)", offset=pos - 2, marker=marker)
            elif marker == M_DRI:
                if len(payload) < 2:
                    raise JpegFormatError("DRI payload too short",
                                          offset=pos, marker=marker)
                restart_interval = int.from_bytes(payload[:2], "big")
            elif marker == M_SOS:
                if len(payload) < 1:
                    raise JpegFormatError("SOS payload empty",
                                          offset=pos, marker=marker)
                ns = payload[0]
                if len(payload) < 1 + 2 * ns + 3:
                    raise JpegFormatError(
                        f"SOS payload too short for {ns} components",
                        offset=pos, marker=marker)
                for i in range(ns):
                    cs, tables = payload[1 + 2 * i], payload[2 + 2 * i]
                    for c in components:
                        if c.comp_id == cs:
                            c.dc_table = tables >> 4
                            c.ac_table = tables & 0xF
                            break
                    else:
                        raise JpegFormatError(
                            f"SOS references unknown component {cs}",
                            offset=pos + 1 + 2 * i, marker=marker)
                # Entropy-coded data runs until the next non-RST marker.
                scan_start = pos + seg_len
                scan_data, pos, complete = _extract_scan(data, scan_start)
                if not complete:
                    # entropy data ran to EOF with no terminating marker
                    if not allow_truncated:
                        raise JpegTruncationError(
                            "entropy-coded data ends before EOI",
                            offset=len(data), marker=M_SOS)
                    truncated = True
                    break
                continue  # pos already advanced past the scan
            pos += seg_len
    except JpegFormatError:
        # Damage *after* a complete scan (e.g. a mangled RST marker
        # terminated the scan early, leaving bytes no marker loop can
        # parse): under allow_truncated the scan prefix is still
        # recoverable, so degrade to a truncated image instead of
        # rejecting. Errors before any scan always propagate.
        if not allow_truncated or scan_data is None:
            raise
        truncated = True
    if scan_data is None:
        if not saw_eoi:
            raise JpegTruncationError(
                "stream ends before any SOS", offset=len(data))
        raise JpegFormatError("no SOS/scan found", offset=pos)
    if not components:
        raise JpegFormatError("no SOF0 found", offset=pos)
    if not truncated and not saw_eoi and pos >= len(data):
        # the scan terminated at a marker, but the stream ended before it
        # could be read as EOI
        if not allow_truncated:
            raise JpegTruncationError("stream ends before EOI",
                                      offset=len(data))
        truncated = True
    return JpegImage(
        width=width,
        height=height,
        components=components,
        quant_tables=quant_tables,
        huffman_specs=huffman_specs,
        scan_data=scan_data,
        restart_interval=restart_interval,
        truncated=truncated,
    )


def _extract_scan(data: bytes, start: int) -> Tuple[bytes, int, bool]:
    """Return (scan bytes incl. RST markers and stuffing, position of the
    next marker, complete). ``complete`` is False when the data ended
    before any terminating (non-RST, non-stuffing) marker — the truncated-
    entropy-data case the resilient parse path recovers from."""
    buf = np.frombuffer(data, dtype=np.uint8)
    n = len(data)
    # Vectorized search: candidate marker positions are 0xFF followed by a byte
    # that is neither 0x00 (stuffing) nor RSTn.
    ff = np.where(buf[start:] == 0xFF)[0] + start
    for f in ff:
        if f + 1 >= n:
            break
        nxt = buf[f + 1]
        if nxt == 0x00 or (M_RST0 <= nxt <= M_RST0 + 7):
            continue
        return data[start:f], int(f), True
    return data[start:n], n, False


# ---------------------------------------------------------------------------
# Scan payload transforms
# ---------------------------------------------------------------------------

def unstuff_scan(scan: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Remove byte stuffing (0xFF 0x00 -> 0xFF) and RST markers.

    Returns (clean_bytes uint8 array, rst_positions) where rst_positions[i] is
    the *bit* offset in the clean stream at which the i-th restart interval
    begins (empty when no RST markers present). RST markers byte-align the
    stream, so clean-stream intervals start at byte boundaries.
    """
    buf = np.frombuffer(scan, dtype=np.uint8)
    if len(buf) == 0:
        return buf.copy(), np.zeros(0, dtype=np.int64)
    ff = buf == 0xFF
    prev_ff = np.concatenate([[False], ff[:-1]])
    is_stuff = prev_ff & (buf == 0x00)
    is_rst_second = prev_ff & (buf >= 0xD0) & (buf <= 0xD7)
    is_rst_first = np.concatenate([is_rst_second[1:], [False]]) & ff
    keep = ~(is_stuff | is_rst_second | is_rst_first)
    clean = buf[keep]
    if is_rst_first.any():
        # Byte index (in clean stream) where each interval after a RST starts.
        kept_before = np.cumsum(keep) - keep  # clean index of each original byte
        starts = kept_before[np.where(is_rst_second)[0]]  # next kept byte index
        rst_bits = (starts.astype(np.int64)) * 8
    else:
        rst_bits = np.zeros(0, dtype=np.int64)
    return clean.copy(), rst_bits


def segment_byte_bounds(clean: np.ndarray, rst_bits: np.ndarray) -> List[int]:
    """Byte offsets delimiting the restart segments of an unstuffed scan.

    Returns ``[0, b1, ..., len(clean)]``: segment i spans
    ``clean[bounds[i]:bounds[i+1]]``. This is the single definition of
    segment framing — both the batch planner (one entropy segment per
    restart interval) and sequential-mode chunk sizing (``chunk_bits`` must
    cover the longest segment so every segment stays one chunk) derive
    from it; they must never disagree.
    """
    return [0] + [int(b) // 8 for b in rst_bits] + [len(clean)]


def stuff_scan(clean: np.ndarray) -> bytes:
    """Apply byte stuffing: insert 0x00 after every 0xFF."""
    clean = np.asarray(clean, dtype=np.uint8)
    n_ff = int((clean == 0xFF).sum())
    if n_ff == 0:
        return clean.tobytes()
    out = np.zeros(len(clean) + n_ff, dtype=np.uint8)
    idx = np.arange(len(clean)) + np.concatenate([[0], np.cumsum(clean == 0xFF)[:-1]])
    out[idx] = clean
    # inserted positions default to 0x00 already
    return out.tobytes()


def pack_bits_to_words(clean: np.ndarray, pad_words: int = 2) -> np.ndarray:
    """Pack a clean byte stream into big-endian uint32 words (MSB-first bits).

    `pad_words` extra zero words are appended so window fetches near the end
    never index out of bounds.
    """
    clean = np.asarray(clean, dtype=np.uint8)
    pad = (-len(clean)) % 4
    padded = np.concatenate([clean, np.zeros(pad, dtype=np.uint8)])
    words = padded.view(">u4").astype(np.uint32)
    return np.concatenate([words, np.zeros(pad_words, dtype=np.uint32)])
