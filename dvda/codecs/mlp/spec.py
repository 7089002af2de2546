"""MLP (Meridian Lossless Packing) decoder — sequential specification.

This module is the framework's *executable specification* of MLP decode
semantics, written for clarity and bit-exactness, not speed.  It is the
correctness anchor: the batched device engine (engine.py, ops/mlp_filter.py,
ops/rematrix.py) and the native host parser are all validated against it,
and it is itself validated byte-for-byte against the reference decoder
(golden tests vs dvda2wav).

Reference analog: src/mlp.c.  Format facts replicated exactly, with their
source lines:

* frame = ``{4p 12u 16p}`` header, total size = field×2 bytes incl. header
  (read_mlp_frame, mlp.c:384-405);
* optional 28-byte major sync ``0xF8726F/0xBB`` (read_major_sync :614-654);
  parameter changes mid-stream cause the frame to be dropped (:449-459);
* per-substream 16-bit info words, ``substream_end`` ×2 = cumulative byte
  offsets; optional 16-bit extraword (:656-668, :463-468);
* substream checkdata: XOR parity (satisfying ``stream_parity ^ data_parity
  == 0xA9``) and a CRC-8 (init 0x3C), over all substream bytes except the
  2 trailing check bytes (:670-712, :1360-1399);
* block structure: optional restart header (sync 0x18F5, :809-854),
  decoding-parameter deltas gated by an 8-flag carry-over mask (:856-993),
  residuals as Huffman MSB + raw LSBs (:1122-1241), per-channel FIR/IIR
  reconstruction (:1243-1306), frame-level rematrixing with an LFSR noise
  pair (:1308-1358), output shifts and RIFF-WAVE channel mapping
  (:514-533, :584-609);
* intentionally preserved implementation quirks of the reference:
  - FIR filter state is **not** reset by restart headers (only IIR state
    is, via decode_decoding_parameters' default/read paths :959-963,
    :979-985); segments are therefore coupled through the last 8 output
    samples — the batched engine handles this via segment chaining;
  - at absolute stream start the reference reads before its state arrays
    when FIR order > history (undefined C behaviour, mlp.c:1285-1287);
    we define missing history as 0;
  - substream 1's checkdata presence uses substream 0's flag (:545);
  - arithmetic is C int32/int64: 64-bit accumulate, arithmetic shifts,
    truncation to 32 bits where the reference casts (:1293, :1350-1353).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...bitstream import BitReader, BitstreamError, crc8_parity
from ..params import StreamParameters, WAVE_CHANNEL
from .codebooks import decode_tree

__all__ = [
    "MAX_CHANNELS",
    "MAX_MATRICES",
    "MlpFrameError",
    "FilterState",
    "MatrixState",
    "ChannelState",
    "SubstreamState",
    "MlpDecoder",
    "mask_quant",
    "to_i32",
]

MAX_CHANNELS = 8   # 6 audio + 2 noise
MAX_MATRICES = 6
MAX_SUBSTREAMS = 2

_I32_MASK = 0xFFFFFFFF


def to_i32(x: int) -> int:
    """Truncate a Python int to C int32 (two's complement)."""
    x &= _I32_MASK
    return x - 0x100000000 if x & 0x80000000 else x


def mask_quant(x: int, q: int) -> int:
    """Zero the low ``q`` bits via arithmetic shifts (mask(), mlp.c:246-253)."""
    return x if q == 0 else (x >> q) << q


class MlpFrameError(ValueError):
    """A malformed frame — the reference would assert/return 0 frames."""


@dataclass
class FilterState:
    shift: int = 0
    coeff: list[int] = field(default_factory=list)
    state: list[int] = field(default_factory=list)


@dataclass
class MatrixState:
    out_channel: int = 0
    lsb_bypass: int = 0
    coeff: list[int] = field(default_factory=lambda: [0] * MAX_CHANNELS)
    bypassed_lsb: list[int] = field(default_factory=list)


@dataclass
class ChannelState:
    fir: FilterState = field(default_factory=FilterState)
    iir: FilterState = field(default_factory=FilterState)
    huffman_offset: int = 0
    codebook: int = 0
    huffman_lsbs: int = 24


@dataclass
class SubstreamState:
    # restart header (mlp.c:55-63)
    min_channel: int = 0
    max_channel: int = 0
    max_matrix_channel: int = 0
    noise_shift: int = 0
    noise_gen_seed: int = 0
    channel_assignment: list[int] = field(default_factory=lambda: [0] * MAX_CHANNELS)
    checksum: int = 0
    # decoding parameters (mlp.c:88-101)
    flags: list[int] = field(default_factory=lambda: [1] * 8)
    block_size: int = 8
    # fixed pool of matrix slots: re-reading matrix parameters overwrites a
    # slot's coefficients but keeps its accumulated bypassed-LSB list, like
    # the reference's static matrix array (mlp.c:94, :481-482, :1189-1203)
    matrix_len: int = 0
    matrix_slots: list[MatrixState] = field(
        default_factory=lambda: [MatrixState() for _ in range(MAX_MATRICES)]
    )
    output_shift: list[int] = field(default_factory=lambda: [0] * MAX_CHANNELS)
    quant_step_size: list[int] = field(default_factory=lambda: [0] * MAX_CHANNELS)
    channels: list[ChannelState] = field(
        default_factory=lambda: [ChannelState() for _ in range(MAX_CHANNELS)]
    )
    # per-frame residual workspace
    residuals: list[list[int]] = field(default_factory=list)
    # channels whose IIR state was reset/reloaded in the current block
    # (parameter read or default-reset) — consumed by the batched planner
    iir_reloaded: set = field(default_factory=set)

    # substream info (mlp.c:48-53), re-read each frame
    info_nonrestart: int = 0
    info_checkdata: int = 0
    info_end: int = 0


class MlpDecoder:
    """Stateful sequential MLP decoder fed packet payload bytes.

    ``decode_bytes(data)`` consumes as many whole frames as possible from
    the accumulated stream and returns the number of PCM frames decoded in
    this call; decoded samples accumulate in ``channel_data`` (RIFF WAVE
    channel order).
    """

    def __init__(self, parameters: StreamParameters):
        self.parameters = parameters
        self._pending = bytearray()
        self.major_sync: StreamParameters | None = None
        self.substream_count = 0
        self.substreams = [SubstreamState() for _ in range(MAX_SUBSTREAMS)]
        out_ch = parameters.channel_count
        self.channel_data: list[list[int]] = [[] for _ in range(out_ch)]
        # per-frame working buffers (framelist, mlp.c:126,279-281)
        self._framelist: list[list[int]] = [[] for _ in range(MAX_CHANNELS)]

    # ------------------------------------------------------------------ feed

    def decode_bytes(self, data: bytes) -> int:
        """Feed packet payload bytes; decode all completed frames
        (dvda_mlpdecoder_decode_packet + mlpdecoder_decode, mlp.c:344-382)."""
        self._pending += data
        decoded = 0
        while True:
            frame = self._next_frame()
            if frame is None:
                return decoded
            # snapshot per-sample state so a dropped frame is state-neutral
            state_snap = [
                (list(ss.channels[c].fir.state), list(ss.channels[c].iir.state))
                for ss in self.substreams for c in range(MAX_CHANNELS)
            ]
            try:
                decoded += self._decode_frame(frame)
            except (MlpFrameError, BitstreamError):
                # Frame dropped; stream continues with the next one.  The
                # reference partially processes bad frames (advancing filter
                # state, sometimes emitting partial sample runs, sometimes
                # crashing on asserts/stale memory); for deterministic
                # behaviour — and so all three engines agree — a dropped
                # frame here leaves NO trace on per-sample state: channel
                # buffers are discarded and filter states restored.  Sticky
                # *parameters* parsed before the error persist, as in the
                # reference.
                for fl in self._framelist:
                    fl.clear()
                it = iter(state_snap)
                for ss in self.substreams:
                    for c in range(MAX_CHANNELS):
                        fir_st, iir_st = next(it)
                        ss.channels[c].fir.state = fir_st
                        ss.channels[c].iir.state = iir_st
                continue

    def _next_frame(self) -> bytes | None:
        """Pop one length-delimited frame body (read_mlp_frame, mlp.c:384-405).

        Returns the frame *body* — the bytes after the 4-byte length header.
        """
        if len(self._pending) < 4:
            return None
        hi, lo = self._pending[0], self._pending[1]
        total = (((hi & 0x0F) << 8) | lo) * 2  # {4p 12u 16p} ×2
        if total < 4 or len(self._pending) < total:
            return None
        frame = bytes(self._pending[4:total])
        del self._pending[:total]
        return frame

    # ----------------------------------------------------------------- frame

    def _decode_frame(self, frame: bytes) -> int:
        r = BitReader(frame)
        ms = self._try_major_sync(r)
        if ms is not None:
            if self.major_sync is not None:
                if ms[0] != self.major_sync:
                    return 0  # parameter change: drop frame (mlp.c:449-455)
            else:
                self.major_sync, self.substream_count = ms
        if self.major_sync is None:
            raise MlpFrameError("no major sync seen yet")

        # substream info words (mlp.c:462-468, :656-668)
        for s in range(self.substream_count):
            ss = self.substreams[s]
            extraword = r.read(1)
            ss.info_nonrestart = r.read(1)
            ss.info_checkdata = r.read(1)
            r.skip(1)
            ss.info_end = r.read(12) * 2
            if extraword:
                r.skip(16)

        ss0 = self.substreams[0]
        data0 = self._extract_substream(r, ss0.info_end, ss0.info_checkdata)
        for m in ss0.matrix_slots:
            m.bypassed_lsb.clear()
        frames0 = self._decode_substream(ss0, BitReader(data0))
        if frames0 == 0:
            raise MlpFrameError("substream 0 decoded no blocks")

        if self.substream_count == 1:
            final = ss0
        else:
            ss1 = self.substreams[1]
            # NB: uses substream 0's checkdata flag (reference quirk, mlp.c:545)
            data1 = self._extract_substream(
                r, ss1.info_end - ss0.info_end, ss0.info_checkdata
            )
            for m in ss1.matrix_slots:
                m.bypassed_lsb.clear()
            frames1 = self._decode_substream(ss1, BitReader(data1))
            if frames1 == 0:
                raise MlpFrameError("substream 1 decoded no blocks")
            final = ss1

        self._finish_frame(final)
        return frames0

    def _finish_frame(self, final: SubstreamState) -> None:
        """Consume a parsed frame (all substreams decoded).  The spec
        rematrixes and emits; the planner records frame-level tensors."""
        self._rematrix(final)
        self._output(final)

    def _try_major_sync(self, r: BitReader):
        """read_major_sync (mlp.c:614-654): parse; rewind if absent."""
        pos = r.getpos()
        try:
            vals = r.parse("24u 8u 4u 4u 4u 4u 11p 5u 48p 1u 15u 4u 92p")
        except BitstreamError:
            r.setpos(pos)
            return None
        sync, stream_type, g0b, g1b, g0r, g1r, chan, _vbr, _peak, nsub = vals
        if sync != 0xF8726F or stream_type != 0xBB or nsub not in (1, 2):
            r.setpos(pos)
            return None
        return StreamParameters(g0b, g1b, g0r, g1r, chan), nsub

    def _extract_substream(self, r: BitReader, length: int, checkdata: int) -> bytes:
        """read_substream (mlp.c:670-712): slice + parity/CRC-8 validation."""
        if checkdata:
            body = r.substream(length - 2).data
            parity_byte = r.read(8)
            crc_byte = r.read(8)
            parity, crc = crc8_parity(body)
            if (parity_byte ^ parity) != 0xA9:
                raise MlpFrameError("substream parity mismatch")
            if crc != crc_byte:
                raise MlpFrameError("substream CRC-8 mismatch")
            return body
        return r.substream(length).data

    # ------------------------------------------------------------- substream

    def _decode_substream(self, ss: SubstreamState, r: BitReader) -> int:
        """decode_substream (mlp.c:714-739)."""
        total = 0
        while True:
            total += self._decode_block(ss, r)
            if r.read(1):
                break
        r.byte_align()
        if r.size() >= 4:
            r.read(32)  # 0xD234D234 end marker, value unchecked (mlp.c:731-736)
        return total

    def _decode_block(self, ss: SubstreamState, r: BitReader) -> int:
        """decode_block (mlp.c:741-807)."""
        ss.iir_reloaded = set()
        if r.read(1):  # decoding parameters present
            restart = r.read(1)
            if restart:
                self._read_restart_header(ss, r)
            self._read_decoding_parameters(ss, r, restart)

        self._read_residuals(ss, r)
        self._process_block(ss)
        return ss.block_size

    def _process_block(self, ss: SubstreamState) -> None:
        """Consume a parsed block.  The sequential spec filters immediately;
        the batched planner overrides this to record tensors instead."""
        for c in range(ss.min_channel, ss.max_channel + 1):
            filtered = self._filter_channel(ss, c)
            self._framelist[c].extend(filtered)

    def _read_restart_header(self, ss: SubstreamState, r: BitReader) -> None:
        """decode_restart_header (mlp.c:809-854)."""
        sync = r.read(13)
        noise_type = r.read(1)
        r.skip(16)  # output timestamp
        ss.min_channel = r.read(4)
        ss.max_channel = r.read(4)
        ss.max_matrix_channel = r.read(4)
        ss.noise_shift = r.read(4)
        ss.noise_gen_seed = r.read(23)
        r.skip(19)
        r.skip(1)   # check data present
        r.skip(8)   # lossless check
        r.skip(16)
        if sync != 0x18F5:
            raise MlpFrameError("restart header sync mismatch")
        if noise_type != 0:
            raise MlpFrameError("unsupported noise type")
        if ss.max_channel < ss.min_channel:
            raise MlpFrameError("max_channel < min_channel")
        if ss.max_matrix_channel < ss.max_channel:
            raise MlpFrameError("max_matrix_channel < max_channel")
        for c in range(ss.max_matrix_channel + 1):
            a = r.read(6)
            if a > ss.max_matrix_channel:
                raise MlpFrameError("bad channel assignment")
            ss.channel_assignment[c] = a
        ss.checksum = r.read(8)

    def _read_decoding_parameters(self, ss: SubstreamState, r: BitReader,
                                  header_present: int) -> None:
        """decode_decoding_parameters (mlp.c:856-993)."""
        if header_present:
            if r.read(1):
                ss.flags = [r.read(1) for _ in range(8)]
            else:
                ss.flags = [1] * 8
        elif ss.flags[0] and r.read(1):
            ss.flags = [r.read(1) for _ in range(8)]

        if ss.flags[7] and r.read(1):
            ss.block_size = r.read(9)
            if ss.block_size < 8:
                raise MlpFrameError("block size < 8")
        elif header_present:
            ss.block_size = 8

        if ss.flags[6] and r.read(1):
            self._read_matrix_parameters(ss, r)
        elif header_present:
            ss.matrix_len = 0

        if ss.flags[5] and r.read(1):
            for c in range(ss.max_matrix_channel + 1):
                ss.output_shift[c] = r.read_signed(4)
        elif header_present:
            ss.output_shift = [0] * MAX_CHANNELS

        if ss.flags[4] and r.read(1):
            for c in range(ss.max_channel + 1):
                ss.quant_step_size[c] = r.read(4)
        elif header_present:
            ss.quant_step_size = [0] * MAX_CHANNELS

        for c in range(ss.min_channel, ss.max_channel + 1):
            ch = ss.channels[c]
            if r.read(1):
                if ss.flags[3] and r.read(1):
                    self._read_filter_parameters(r, ch.fir, is_iir=False)
                elif header_present:
                    ch.fir.shift = 0
                    ch.fir.coeff = []
                if ss.flags[2] and r.read(1):
                    self._read_filter_parameters(r, ch.iir, is_iir=True)
                    ss.iir_reloaded.add(c)
                elif header_present:
                    ch.iir.shift = 0
                    ch.iir.coeff = []
                    ch.iir.state = []
                    ss.iir_reloaded.add(c)
                if ss.flags[1] and r.read(1):
                    ch.huffman_offset = r.read_signed(15)
                elif header_present:
                    ch.huffman_offset = 0
                ch.codebook = r.read(2)
                ch.huffman_lsbs = r.read(5)
                if ch.huffman_lsbs > 24:
                    raise MlpFrameError("huffman_lsbs > 24")
            elif header_present:
                ch.fir.shift = 0
                ch.fir.coeff = []
                ch.iir.shift = 0
                ch.iir.coeff = []
                ch.iir.state = []
                ss.iir_reloaded.add(c)
                ch.huffman_offset = 0
                ch.codebook = 0
                ch.huffman_lsbs = 24

    def _read_matrix_parameters(self, ss: SubstreamState, r: BitReader) -> None:
        """decode_matrix_parameters (mlp.c:995-1027)."""
        count = r.read(4)
        if count > MAX_MATRICES:
            # the reference would overflow its 6-slot array here (C UB);
            # we reject the frame instead
            raise MlpFrameError("matrix count > 6")
        for i in range(count):
            m = ss.matrix_slots[i]
            m.out_channel = r.read(4)
            if m.out_channel > ss.max_matrix_channel:
                raise MlpFrameError("matrix out_channel out of range")
            frac = r.read(4)
            if frac > 14:
                raise MlpFrameError("fractional_bits > 14")
            m.lsb_bypass = r.read(1)
            m.coeff = [0] * MAX_CHANNELS
            for c in range(ss.max_matrix_channel + 3):
                if r.read(1):
                    m.coeff[c] = r.read_signed(frac + 2) << (14 - frac)
        ss.matrix_len = count

    def _read_filter_parameters(self, r: BitReader, f: FilterState,
                                is_iir: bool) -> None:
        """decode_FIR_parameters / decode_IIR_parameters (mlp.c:1029-1120)."""
        order = r.read(4)
        if order > 8:
            raise MlpFrameError("filter order > 8")
        if order == 0:
            f.shift = 0
            f.coeff = []
            if is_iir:
                f.state = []
            return
        f.shift = r.read(4)
        coeff_bits = r.read(5)
        if not (1 <= coeff_bits <= 16):
            raise MlpFrameError("coeff_bits out of range")
        coeff_shift = r.read(3)
        if coeff_bits + coeff_shift > 16:
            raise MlpFrameError("coeff_bits + coeff_shift > 16")
        f.coeff = [r.read_signed(coeff_bits) << coeff_shift for _ in range(order)]
        if is_iir:
            f.state = []
            if r.read(1):
                state_bits = r.read(4)
                state_shift = r.read(4)
                vals = [r.read_signed(state_bits) << state_shift
                        for _ in range(order)]
                f.state = vals[::-1]  # reference reverses (mlp.c:1107)
        else:
            if r.read(1):
                raise MlpFrameError("FIR state flag set")

    # ------------------------------------------------------------- residuals

    def _read_residuals(self, ss: SubstreamState, r: BitReader) -> None:
        """decode_residual_data (mlp.c:1122-1241)."""
        lsb_bits = {}
        offsets = {}
        for c in range(ss.min_channel, ss.max_channel + 1):
            ch = ss.channels[c]
            lb = ch.huffman_lsbs - ss.quant_step_size[c]
            if lb < 0:
                # the reference's unsigned width wraps huge and aborts the
                # read (frame drop); treat negative widths as a stream error
                raise MlpFrameError("huffman_lsbs < quant_step_size")
            lsb_bits[c] = lb
            if ch.codebook:
                sign_shift = lb + 2 - ch.codebook
                off = ch.huffman_offset - (7 << lb)
                if sign_shift >= 0:
                    off -= 1 << sign_shift
            else:
                sign_shift = lb - 1
                off = ch.huffman_offset
                if sign_shift >= 0:
                    off -= 1 << sign_shift
            offsets[c] = off

        ss.residuals = [[] for _ in range(ss.max_channel + 1)]
        trees = {c: decode_tree(ss.channels[c].codebook)
                 for c in range(ss.min_channel, ss.max_channel + 1)
                 if ss.channels[c].codebook}

        bs = ss.block_size
        active = ss.matrix_slots[: ss.matrix_len]
        for _ in range(bs):
            for m in active:
                m.bypassed_lsb.append(r.read(1) if m.lsb_bypass else 0)
            for c in range(ss.min_channel, ss.max_channel + 1):
                ch = ss.channels[c]
                if ch.codebook:
                    msb = r.read_huffman_code(trees[c])
                else:
                    msb = 0
                lsb = r.read(lsb_bits[c])
                q = ss.quant_step_size[c]
                ss.residuals[c].append(
                    to_i32(((msb << lsb_bits[c]) + lsb + offsets[c]) << q)
                )

    # --------------------------------------------------------------- filters

    def _filter_channel(self, ss: SubstreamState, c: int) -> list[int]:
        """filter_channel (mlp.c:1243-1306): AR reconstruction with 64-bit
        accumulate, arithmetic shift, and quant-step masking."""
        ch = ss.channels[c]
        fir, iir = ch.fir, ch.iir
        residuals = ss.residuals[c]
        if len(fir.coeff) + len(iir.coeff) > 8:
            raise MlpFrameError("FIR+IIR order > 8")
        if fir.shift > 0 and iir.shift > 0:
            if fir.shift != iir.shift:
                raise MlpFrameError("FIR/IIR shift mismatch")
            shift = fir.shift
        elif fir.coeff:
            shift = fir.shift
        else:
            shift = iir.shift

        q = ss.quant_step_size[c]
        fs, is_ = fir.state, iir.state
        out = []
        for res in residuals:
            acc = 0
            for j, fc in enumerate(fir.coeff):
                h = fs[-1 - j] if j < len(fs) else 0  # zero history at start
                acc += fc * h
            for k, ic in enumerate(iir.coeff):
                h = is_[-1 - k] if k < len(is_) else 0
                acc += ic * h
            shifted = to_i32(acc >> shift)
            value = mask_quant(to_i32(shifted + res), q)
            out.append(value)
            fs.append(value)
            is_.append(to_i32(value - shifted))
        del fs[:-8]
        del is_[:-8]
        return out

    # -------------------------------------------------------------- rematrix

    def _rematrix(self, ss: SubstreamState) -> None:
        """rematrix_channels (mlp.c:1308-1358): LFSR noise pair + sequential
        in-place matrix application over the whole frame."""
        n = len(self._framelist[0])
        # corrupt streams can leave channels ragged (the reference reads or
        # writes stale memory there); zero-fill so rematrixing is defined
        for c in range(ss.max_matrix_channel + 1):
            fl = self._framelist[c]
            if len(fl) < n:
                fl.extend([0] * (n - len(fl)))
        seed = ss.noise_gen_seed
        noise0, noise1 = [], []
        shift = ss.noise_shift
        for _ in range(n):
            shifted = (seed >> 7) & 0xFFFF
            b0 = (seed >> 15) & 0xFF
            b1 = shifted & 0xFF
            noise0.append(((b0 - 0x100) if b0 & 0x80 else b0) << shift)
            noise1.append(((b1 - 0x100) if b1 & 0x80 else b1) << shift)
            seed = (((seed << 16) & _I32_MASK) ^ shifted ^ (shifted << 5))
        ss.noise_gen_seed = seed

        for m in ss.matrix_slots[: ss.matrix_len]:
            q = ss.quant_step_size[m.out_channel]
            dst = self._framelist[m.out_channel]
            bl = m.bypassed_lsb
            nb = len(bl)
            for i in range(n):
                acc = 0
                for c in range(ss.max_matrix_channel + 1):
                    fl = self._framelist[c]
                    # ragged channels only occur on corrupt streams (the
                    # reference reads stale memory / crashes there)
                    acc += (fl[i] if i < len(fl) else 0) * m.coeff[c]
                acc += noise0[i] * m.coeff[ss.max_matrix_channel + 1]
                acc += noise1[i] * m.coeff[ss.max_matrix_channel + 2]
                # i >= nb can only happen when a matrix slot became active
                # mid-frame — the reference reads stale heap there; we use 0
                dst[i] = to_i32(
                    mask_quant(to_i32(acc >> 14), q) + (bl[i] if i < nb else 0)
                )

    def _output(self, ss: SubstreamState) -> None:
        """Output shifts + RIFF WAVE channel mapping (mlp.c:514-533/:584-609)."""
        for c in range(ss.max_matrix_channel + 1):
            sh = ss.output_shift[c] & 31  # see module docstring: C UB for <0
            if sh:
                fl = self._framelist[c]
                for i in range(len(fl)):
                    fl[i] = to_i32(fl[i] << sh)
        mapping = WAVE_CHANNEL[self.major_sync.channel_assignment]
        n = len(self._framelist[0])
        for c in range(len(self.channel_data)):
            fl = self._framelist[c]
            if len(fl) < n:  # ragged frame from a corrupt stream: zero-fill
                fl.extend([0] * (n - len(fl)))
            self.channel_data[mapping[c]].extend(fl[:n])
        for fl in self._framelist:
            fl.clear()

    # ---------------------------------------------------------------- output

    def take_frames(self, n: int | None = None) -> np.ndarray:
        """Pop up to ``n`` decoded PCM frames as int32 [n, channels]."""
        avail = len(self.channel_data[0])
        n = avail if n is None else min(n, avail)
        out = np.empty((n, len(self.channel_data)), dtype=np.int32)
        for c, ch in enumerate(self.channel_data):
            out[:, c] = ch[:n]
            del ch[:n]
        return out
