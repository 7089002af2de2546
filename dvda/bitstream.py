"""Bitstream kernel: big-endian bit readers/writers over in-memory buffers.

This is the L1 layer of the framework (reference analog:
/root/reference/src/bitstream.{h,c}).  The reference implements a table-driven
9-bit state machine with four I/O backends, a setjmp/longjmp error stack and a
per-byte callback stack.  None of that survives the batched redesign:

* All parsing here is **host-side control flow** over in-memory ``bytes``
  buffers (sectors are read in bulk by the container layer), so a single
  buffer-backed reader replaces the FILE/queue/external backends.  Streaming
  accumulation (the reference's BitstreamQueue, bitstream.c:943) is provided
  by :class:`ByteQueue`.
* Errors are ordinary Python exceptions (:class:`BitstreamError`) instead of
  setjmp/longjmp (bitstream.c:2476-2517).
* The per-byte callback stack (bitstream.h:350-375) — used only for the MLP
  CRC-8/parity tap (mlp.c:682-688) — is replaced by vectorised whole-range
  checks in :func:`crc8_parity` since substream extraction is byte-aligned.
* The hot decode paths (PCM unpack, MLP residual Huffman) do not use this
  class at all: they run either in the native host library
  (``dvda.host``) or on-device; this Python reader is the *specification*
  and the control-plane parser.

Bit order matches the reference: most-significant-bit first, big-endian
(``FUNC_READ_BITS_BE``, bitstream.c:1077).  ``read_signed`` reads the sign bit
first then ``count-1`` magnitude bits (br_read_signed_bits_be,
bitstream.c:1198-1206).

The ``parse``/``build`` format mini-language is kept because the IFO/packet
layouts are most readably expressed with it (bitstream.h:303-348):

    ===== ======================= =================
    code  action                  returns/consumes
    ===== ======================= =================
    Nu    read N bits unsigned    int
    Ns    read N bits signed      int
    Np    skip N bits             —
    NP    skip N bytes            —
    Nb    read N bytes            bytes
    a     byte-align              —
    N*    repeat next code N×     —
    ===== ======================= =================
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "BitstreamError",
    "BitReader",
    "BitWriter",
    "ByteQueue",
    "crc8_parity",
    "CRC8_TABLE",
    "format_byte_size",
]


class BitstreamError(IOError):
    """Raised on reads past the end of a stream (reference: br_abort)."""


def _parse_format(fmt: str):
    """Yield (count, code) pairs from a parse/build format string."""
    count = 0
    times = 1
    for ch in fmt:
        if ch.isdigit():
            count = count * 10 + int(ch)
        elif ch == "*":
            times = count
            count = 0
        elif ch in "uspPb":
            for _ in range(times):
                yield count, ch
            count = 0
            times = 1
        elif ch == "a":
            yield 0, "a"
            count = 0
            times = 1
        elif ch.isspace():
            continue
        else:
            raise ValueError(f"bad format character {ch!r} in {fmt!r}")


def format_byte_size(fmt: str) -> int:
    """Size of a format string in bytes (reference: bs_format_byte_size)."""
    bits = 0
    for count, code in _parse_format(fmt):
        if code in "usp":
            bits += count
        elif code in "Pb":
            bits += 8 * count
    return bits // 8


class BitReader:
    """MSB-first big-endian bit reader over an in-memory buffer."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data, start_bit: int = 0, end_bit: int | None = None):
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        elif isinstance(data, (bytearray, memoryview)):
            data = bytes(data)
        self.data: bytes = data
        self.pos: int = start_bit
        self.end: int = 8 * len(data) if end_bit is None else end_bit

    # -- position ---------------------------------------------------------

    def getpos(self) -> int:
        """Current position in bits (reference: br_getpos)."""
        return self.pos

    def setpos(self, pos: int) -> None:
        self.pos = pos

    def seek_bytes(self, byte_offset: int) -> None:
        """Absolute byte seek (reference: br_seek with BS_SEEK_SET)."""
        self.pos = 8 * byte_offset

    def size(self) -> int:
        """Whole bytes remaining (reference: br_size_*)."""
        return max(0, (self.end - self.pos)) // 8

    def bits_remaining(self) -> int:
        return max(0, self.end - self.pos)

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    # -- reads ------------------------------------------------------------

    def read(self, n: int) -> int:
        """Read ``n`` bits as an unsigned int.

        ``n < 0`` raises: the reference's unsigned bit counts wrap huge and
        abort on EOF (e.g. MLP LSB widths when quant > huffman_lsbs), so a
        negative width is always a stream error.
        """
        if n <= 0:
            if n == 0:
                return 0
            raise BitstreamError("negative bit-read width")
        p = self.pos
        q = p + n
        if q > self.end:
            raise BitstreamError("read past end of stream")
        self.pos = q
        i0 = p >> 3
        i1 = (q + 7) >> 3
        word = int.from_bytes(self.data[i0:i1], "big")
        return (word >> ((i1 << 3) - q)) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        """Sign bit first, then ``n-1`` magnitude bits (two's complement)."""
        if self.read(1):
            return self.read(n - 1) - (1 << (n - 1))
        return self.read(n - 1)

    def read_bigint(self, n: int) -> int:
        """Read an arbitrarily wide unsigned field (reference analog:
        ``br_read_bits_bigint`` backed by vendored mini-gmp,
        bitstream.h:176-186).  Python ints are arbitrary precision, so
        this is :meth:`read` — the whole mini-gmp dependency (4.7 kLoC)
        designs out."""
        return self.read(n)

    def read_signed_bigint(self, n: int) -> int:
        """Arbitrary-width two's-complement read (br_read_signed_bigint)."""
        return self.read_signed(n)

    def read_unary(self, stop_bit: int) -> int:
        """Count bits until ``stop_bit`` is seen (reference: br_read_unary)."""
        count = 0
        while self.read(1) != stop_bit:
            count += 1
        return count

    def skip(self, n: int) -> None:
        q = self.pos + n
        if q > self.end:
            raise BitstreamError("skip past end of stream")
        self.pos = q

    def skip_bytes(self, n: int) -> None:
        self.skip(8 * n)

    def read_bytes(self, n: int) -> bytes:
        if self.pos % 8 == 0:
            p = self.pos >> 3
            q = p + n
            if 8 * q > self.end:
                raise BitstreamError("read past end of stream")
            self.pos = 8 * q
            return self.data[p:q]
        return bytes(self.read(8) for _ in range(n))

    def unread_bit(self, bit: int) -> None:
        """Step back one bit (reference: br_unread_bit).

        The buffer is immutable, so this only rewinds the position; the
        caller must push back the same bit value it read.
        """
        del bit
        self.pos -= 1

    def substream(self, nbytes: int) -> "BitReader":
        """Extract the next ``nbytes`` as an independent reader.

        Must be byte-aligned, like every substream use in the reference
        decode path (packet.c:107, mlp.c:394/:686).
        """
        if self.pos % 8:
            raise BitstreamError("substream from unaligned position")
        p = self.pos >> 3
        if 8 * (p + nbytes) > self.end:
            raise BitstreamError("substream past end of stream")
        self.pos += 8 * nbytes
        return BitReader(self.data[p : p + nbytes])

    def parse(self, fmt: str):
        """Apply a format string; returns the list of u/s/b values read."""
        out = []
        for count, code in _parse_format(fmt):
            if code == "u":
                out.append(self.read(count))
            elif code == "s":
                out.append(self.read_signed(count))
            elif code == "p":
                self.skip(count)
            elif code == "P":
                self.skip_bytes(count)
            elif code == "b":
                out.append(self.read_bytes(count))
            elif code == "a":
                self.byte_align()
        return out

    def read_huffman_code(self, tree) -> int:
        """Walk a binary prefix tree: nodes are ``(zero_child, one_child)``
        tuples, leaves are ints (value) — ``None`` marks an invalid code.

        Matches the semantics of the reference's state-machine jump tables
        (bitstream.c:1806-1833) for the MLP codebooks; the fast decoders use
        a flat peek-LUT instead (see codecs/mlp/codebooks.py).
        """
        node = tree
        while isinstance(node, tuple):
            node = node[self.read(1)]
        if node is None:
            raise BitstreamError("invalid Huffman code")
        return node


class ByteQueue:
    """Growable FIFO of bytes with a read cursor.

    Reference analog: BitstreamQueue (br_open_queue, bitstream.c:943).  Used
    by the MLP path to accumulate packet payloads that may split MLP frames
    across packets.  Reads happen through a :class:`BitReader` view; call
    :meth:`reader` to get one positioned at the current cursor, and
    :meth:`commit` to advance the cursor after successful parses.
    """

    def __init__(self, data: bytes = b""):
        self._buf = bytearray(data)
        self._cursor = 0  # bytes consumed

    def push(self, data: bytes) -> None:
        self._buf += data

    def size(self) -> int:
        return len(self._buf) - self._cursor

    def reader(self) -> BitReader:
        return BitReader(bytes(self._buf[self._cursor :]))

    def commit(self, nbytes: int) -> None:
        self._cursor += nbytes
        # periodically compact so memory stays bounded on long streams
        if self._cursor > 1 << 20 and self._cursor > len(self._buf) // 2:
            del self._buf[: self._cursor]
            self._cursor = 0

    def peek_all(self) -> bytes:
        return bytes(self._buf[self._cursor :])


# -- MLP substream checkdata ----------------------------------------------

# CRC-8 table from the reference checkdata_callback (mlp.c:1363-1395);
# polynomial table for the MLP substream CRC.
CRC8_TABLE = np.array(
    [
        0x00, 0x63, 0xC6, 0xA5, 0xEF, 0x8C, 0x29, 0x4A,
        0xBD, 0xDE, 0x7B, 0x18, 0x52, 0x31, 0x94, 0xF7,
        0x19, 0x7A, 0xDF, 0xBC, 0xF6, 0x95, 0x30, 0x53,
        0xA4, 0xC7, 0x62, 0x01, 0x4B, 0x28, 0x8D, 0xEE,
        0x32, 0x51, 0xF4, 0x97, 0xDD, 0xBE, 0x1B, 0x78,
        0x8F, 0xEC, 0x49, 0x2A, 0x60, 0x03, 0xA6, 0xC5,
        0x2B, 0x48, 0xED, 0x8E, 0xC4, 0xA7, 0x02, 0x61,
        0x96, 0xF5, 0x50, 0x33, 0x79, 0x1A, 0xBF, 0xDC,
        0x64, 0x07, 0xA2, 0xC1, 0x8B, 0xE8, 0x4D, 0x2E,
        0xD9, 0xBA, 0x1F, 0x7C, 0x36, 0x55, 0xF0, 0x93,
        0x7D, 0x1E, 0xBB, 0xD8, 0x92, 0xF1, 0x54, 0x37,
        0xC0, 0xA3, 0x06, 0x65, 0x2F, 0x4C, 0xE9, 0x8A,
        0x56, 0x35, 0x90, 0xF3, 0xB9, 0xDA, 0x7F, 0x1C,
        0xEB, 0x88, 0x2D, 0x4E, 0x04, 0x67, 0xC2, 0xA1,
        0x4F, 0x2C, 0x89, 0xEA, 0xA0, 0xC3, 0x66, 0x05,
        0xF2, 0x91, 0x34, 0x57, 0x1D, 0x7E, 0xDB, 0xB8,
        0xC8, 0xAB, 0x0E, 0x6D, 0x27, 0x44, 0xE1, 0x82,
        0x75, 0x16, 0xB3, 0xD0, 0x9A, 0xF9, 0x5C, 0x3F,
        0xD1, 0xB2, 0x17, 0x74, 0x3E, 0x5D, 0xF8, 0x9B,
        0x6C, 0x0F, 0xAA, 0xC9, 0x83, 0xE0, 0x45, 0x26,
        0xFA, 0x99, 0x3C, 0x5F, 0x15, 0x76, 0xD3, 0xB0,
        0x47, 0x24, 0x81, 0xE2, 0xA8, 0xCB, 0x6E, 0x0D,
        0xE3, 0x80, 0x25, 0x46, 0x0C, 0x6F, 0xCA, 0xA9,
        0x5E, 0x3D, 0x98, 0xFB, 0xB1, 0xD2, 0x77, 0x14,
        0xAC, 0xCF, 0x6A, 0x09, 0x43, 0x20, 0x85, 0xE6,
        0x11, 0x72, 0xD7, 0xB4, 0xFE, 0x9D, 0x38, 0x5B,
        0xB5, 0xD6, 0x73, 0x10, 0x5A, 0x39, 0x9C, 0xFF,
        0x08, 0x6B, 0xCE, 0xAD, 0xE7, 0x84, 0x21, 0x42,
        0x9E, 0xFD, 0x58, 0x3B, 0x71, 0x12, 0xB7, 0xD4,
        0x23, 0x40, 0xE5, 0x86, 0xCC, 0xAF, 0x0A, 0x69,
        0x87, 0xE4, 0x41, 0x22, 0x68, 0x0B, 0xAE, 0xCD,
        0x3A, 0x59, 0xFC, 0x9F, 0xD5, 0xB6, 0x13, 0x70,
    ],
    dtype=np.uint8,
)


def crc8_parity(data: bytes | np.ndarray) -> tuple[int, int]:
    """Return ``(parity, final_crc)`` over a byte range.

    Replaces the reference's per-byte callback accumulation
    (checkdata_callback, mlp.c:1360-1399): parity is the XOR of all bytes;
    the CRC starts at 0x3C and steps ``crc = CRC8[crc ^ byte]`` with the
    *pre-table* value (``final_crc``) being what is compared against the
    stream's CRC byte (mlp.c:677, :699-705).
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    parity = int(np.bitwise_xor.reduce(arr)) if arr.size else 0
    crc = 0x3C
    final = 0
    table = CRC8_TABLE
    for b in arr.tolist():
        final = crc ^ b
        crc = int(table[final])
    return parity, final


class BitWriter:
    """MSB-first bit writer into a growable buffer.

    Reference analog: BitstreamWriter (bw_open, bitstream.c:2520).  Supports
    the byte-aligned getpos/setpos rewrite pattern used by the WAV writer to
    back-patch headers (dvda2wav.c:316,337); endianness is per-write-call via
    the little-endian helpers rather than a stream mode.
    """

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0  # pending bits (MSB-first)
        self._nacc = 0

    # -- big-endian writes -------------------------------------------------

    def write(self, n: int, value: int) -> None:
        value &= (1 << n) - 1 if n else 0
        self._acc = (self._acc << n) | value
        self._nacc += n
        while self._nacc >= 8:
            self._nacc -= 8
            self._buf.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_signed(self, n: int, value: int) -> None:
        self.write(n, value & ((1 << n) - 1))

    def write_bigint(self, n: int, value: int) -> None:
        """Arbitrary-width unsigned write (reference analog:
        ``bw_write_bits_bigint``, bitstream.h:839-910 writer family —
        mini-gmp-backed there; plain :meth:`write` here since the
        accumulator is a Python bignum)."""
        self.write(n, value)

    def write_signed_bigint(self, n: int, value: int) -> None:
        """Arbitrary-width two's-complement write."""
        self.write(n, value & ((1 << n) - 1))

    def write_unary(self, stop_bit: int, value: int) -> None:
        for _ in range(value):
            self.write(1, 1 - stop_bit)
        self.write(1, stop_bit)

    def write_bytes(self, data: bytes) -> None:
        if self._nacc == 0:
            self._buf += data
        else:
            for b in data:
                self.write(8, b)

    def byte_align(self) -> None:
        if self._nacc:
            self.write(8 - self._nacc, 0)

    # -- little-endian whole-field writes (for RIFF WAVE) ------------------

    def write_le(self, n: int, value: int) -> None:
        """Write an n-bit little-endian field; n must be a multiple of 8."""
        assert n % 8 == 0 and self._nacc == 0
        self._buf += int(value & ((1 << n) - 1)).to_bytes(n // 8, "little")

    def write_signed_le(self, n: int, value: int) -> None:
        self.write_le(n, value & ((1 << n) - 1))

    def build(self, fmt: str, *values) -> None:
        """Inverse of BitReader.parse: write values per the format string
        (reference: bw build, bitstream.h:758-790)."""
        it = iter(values)
        for count, code in _parse_format(fmt):
            if code == "u":
                self.write(count, next(it))
            elif code == "s":
                self.write_signed(count, next(it))
            elif code == "p":
                self.write(count, 0)
            elif code == "P":
                self.write_bytes(bytes(count))
            elif code == "b":
                data = next(it)
                assert len(data) == count
                self.write_bytes(data)
            elif code == "a":
                self.byte_align()

    # -- positions ----------------------------------------------------------

    def getpos(self) -> int:
        assert self._nacc == 0
        return len(self._buf)

    def overwrite_at(self, pos: int, data: bytes) -> None:
        self._buf[pos : pos + len(data)] = data

    def getvalue(self) -> bytes:
        assert self._nacc == 0, "stream not byte-aligned"
        return bytes(self._buf)
