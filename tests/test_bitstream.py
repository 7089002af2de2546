"""Bitstream kernel unit tests (reference semantics: src/bitstream.c)."""

import numpy as np
import pytest

from dvda.bitstream import (
    BitReader,
    BitWriter,
    BitstreamError,
    ByteQueue,
    crc8_parity,
    format_byte_size,
)


def test_read_msb_first():
    r = BitReader(bytes([0b10110001, 0b11000000]))
    assert r.read(1) == 1
    assert r.read(3) == 0b011
    assert r.read(4) == 0b0001
    assert r.read(2) == 0b11
    assert r.read(0) == 0
    assert r.bits_remaining() == 6


def test_read_across_bytes():
    r = BitReader(bytes([0x12, 0x34, 0x56, 0x78]))
    assert r.read(32) == 0x12345678
    r = BitReader(bytes([0x12, 0x34, 0x56, 0x78]))
    assert r.read(4) == 1
    assert r.read(24) == 0x234567
    assert r.read(4) == 0x8


def test_read_signed():
    # sign bit first, then count-1 magnitude bits (bitstream.c:1198-1206)
    w = BitWriter()
    w.write(4, 0b0111)  # +7 in 4 bits
    w.write(4, 0b1001)  # 9 - 8 = ... sign=1, mag=001 -> 1 - 8 = -7
    r = BitReader(w.getvalue())
    assert r.read_signed(4) == 7
    assert r.read_signed(4) == -7


def test_signed_roundtrip_exhaustive():
    for bits in (2, 4, 7, 15):
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        w = BitWriter()
        values = list(range(lo, hi + 1))
        for v in values:
            w.write_signed(bits, v)
        w.byte_align()
        r = BitReader(w.getvalue())
        assert [r.read_signed(bits) for _ in values] == values


def test_eof_raises():
    r = BitReader(b"\x00")
    r.read(8)
    with pytest.raises(BitstreamError):
        r.read(1)


def test_parse_format():
    w = BitWriter()
    w.write(16, 0xBEEF)
    w.write(8, 0)        # 8p
    w.write(4, 0xA)
    w.write(4, 0x5)
    w.write_bytes(b"xy")  # 2P
    w.write_bytes(b"hello")
    r = BitReader(w.getvalue())
    assert r.parse("16u 8p 4u 4u 2P 5b") == [0xBEEF, 0xA, 0x5, b"hello"]


def test_parse_multiplier():
    w = BitWriter()
    for v in (1, 0, 1, 1):
        w.write(1, v)
    w.byte_align()
    r = BitReader(w.getvalue())
    assert r.parse("4*1u") == [1, 0, 1, 1]


def test_format_byte_size():
    assert format_byte_size("16u 16u 32u 32u 16u 16u 16u 16u 32u 16b") == 40
    assert format_byte_size("4b 32u") == 8


def test_unary():
    w = BitWriter()
    w.write_unary(1, 5)  # five 0s then a 1
    w.write_unary(1, 0)
    w.byte_align()
    r = BitReader(w.getvalue())
    assert r.read_unary(1) == 5
    assert r.read_unary(1) == 0


def test_substream_and_positions():
    r = BitReader(bytes(range(16)))
    r.skip_bytes(4)
    pos = r.getpos()
    sub = r.substream(4)
    assert sub.read_bytes(4) == bytes([4, 5, 6, 7])
    assert r.read(8) == 8
    r.setpos(pos)
    assert r.read(8) == 4


def test_byte_queue():
    q = ByteQueue()
    q.push(b"abc")
    q.push(b"def")
    assert q.size() == 6
    r = q.reader()
    assert r.read_bytes(2) == b"ab"
    q.commit(2)
    assert q.size() == 4
    assert q.reader().read_bytes(4) == b"cdef"


def test_crc8_parity_empty():
    assert crc8_parity(b"") == (0, 0)


def test_crc8_parity_basic():
    # hand-step the reference algorithm (mlp.c:1360-1399) for 2 bytes
    from dvda.bitstream import CRC8_TABLE

    data = bytes([0x12, 0x34])
    crc = 0x3C
    final = 0
    parity = 0
    for b in data:
        parity ^= b
        final = crc ^ b
        crc = int(CRC8_TABLE[final])
    assert crc8_parity(data) == (parity, final)


def test_writer_le_fields():
    w = BitWriter()
    w.write_le(32, 0x11223344)
    w.write_le(16, 0xBEEF)
    assert w.getvalue() == bytes([0x44, 0x33, 0x22, 0x11, 0xEF, 0xBE])


def test_reader_numpy_input():
    arr = np.array([0xAB, 0xCD], dtype=np.uint8)
    r = BitReader(arr)
    assert r.read(16) == 0xABCD


def test_writer_build_roundtrips_parse():
    w = BitWriter()
    w.build("16u 8p 4u 4s 2P 3b a", 0xBEEF, 0xA, -3, b"xyz")
    r = BitReader(w.getvalue())
    assert r.parse("16u 8p 4u 4s 2P 3b") == [0xBEEF, 0xA, -3, b"xyz"]


def test_bigint_round_trip():
    """>64-bit fields (reference: mini-gmp-backed br_read_bits_bigint /
    bw_write_bits_bigint, bitstream.h:176-186) round-trip at any width —
    Python bignums replace the vendored 4.7 kLoC dependency."""
    from dvda.bitstream import BitReader, BitWriter

    big = (1 << 999) | (1 << 500) | 0xDEADBEEF
    neg = -(1 << 900) + 12345
    w = BitWriter()
    w.write(3, 5)                    # misalign first
    w.write_bigint(1000, big)
    w.write_signed_bigint(901, neg)
    w.write(5, 17)
    w.byte_align()
    r = BitReader(w.getvalue())
    assert r.read(3) == 5
    assert r.read_bigint(1000) == big
    assert r.read_signed_bigint(901) == neg
    assert r.read(5) == 17
