"""Public API: the dvd-audio.h object model re-exposed over batched decode.

Reference analog: include/dvd-audio.h (dvda_open → titleset → title → track
→ track reader → dvda_read) and src/dvd-audio.c.  The object hierarchy, 1-based
indices and RIFF-WAVE-ordered interleaved output are preserved; the decode
underneath is inverted from the reference's sample-at-a-time pull loop into a
host *planner* (parse/demux/tensorise) plus a device *executor* (vectorised
kernels) per SURVEY §7.  ``TrackReader.read`` serves from the cached batched
decode.

Python-idiomatic niceties (context managers, iteration) are added on top; the
C-style functions (``dvda_open`` etc.) are provided in dvda.__init__ for
API parity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .bitstream import BitReader, BitstreamError
from .config import DecodeConfig, default_config
from .container.aob import AOBReader
from .container.audio_ts import find_audio_ts_file
from .container import ifo as ifo_mod
from .container.packet import demux_audio_packets, read_audio_packet_header
from .codecs import pcm as pcm_codec
from .codecs.params import (
    MLP_CODEC_ID,
    PCM_CODEC_ID,
    PTS_PER_SECOND,
)

__all__ = ["DVDA", "Titleset", "Title", "Track", "TrackReader", "open_disc"]


class DvdaError(RuntimeError):
    pass


def _make_decrypt(audio_ts_path: str, device: str | None):
    """Build the optional CPPM sector decryptor (aob.c:127-142 analog)."""
    mkb_path = find_audio_ts_file(audio_ts_path, "DVDAUDIO.MKB")
    if mkb_path is None or device is None:
        return None
    try:
        from .cppm.decrypt import CppmDecryptor

        return CppmDecryptor.from_device(device, mkb_path).decrypt_sectors
    except Exception:
        return None


class DVDA:
    """A DVD-Audio disc (reference: dvda_open, dvd-audio.c:324-353)."""

    def __init__(self, audio_ts_path: str | os.PathLike,
                 device: str | None = None,
                 config: DecodeConfig | None = None):
        audio_ts_path = os.fspath(audio_ts_path)
        ifo_path = find_audio_ts_file(audio_ts_path, "audio_ts.ifo")
        if ifo_path is None:
            raise DvdaError(f"AUDIO_TS.IFO not found under {audio_ts_path}")
        with open(ifo_path, "rb") as f:
            self._titleset_count = ifo_mod.parse_audio_ts_ifo(f.read())
        if self._titleset_count == 0:
            raise DvdaError("invalid AUDIO_TS.IFO")
        self.audio_ts_path = audio_ts_path
        self.device = device
        #: explicit config, or None = environment-derived at decode time
        self.config = config

    @property
    def titleset_count(self) -> int:
        return self._titleset_count

    def open_titleset(self, titleset: int) -> "Titleset":
        return Titleset(self, titleset)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Titleset:
    """A titleset (reference: dvda_open_titleset, dvd-audio.c:369-413)."""

    def __init__(self, dvda: DVDA, titleset: int):
        name = f"ATS_{min(titleset, 99):02d}_0.IFO"
        path = find_audio_ts_file(dvda.audio_ts_path, name)
        if path is None:
            raise DvdaError(f"{name} not found")
        with open(path, "rb") as f:
            self._ifo = ifo_mod.parse_ats_ifo(f.read())
        self.dvda = dvda
        self.number = titleset

    @property
    def title_count(self) -> int:
        return self._ifo.title_count

    def open_title(self, title: int) -> "Title":
        toc = ifo_mod.resolve_title_toc(self._ifo, title)
        return Title(self, toc)

    def close(self) -> None:
        pass


class Title:
    """A title (reference: dvda_open_title, dvd-audio.c:437-502)."""

    def __init__(self, titleset: Titleset, toc: ifo_mod.TitleToc):
        self.titleset = titleset
        self._toc = toc
        self.number = toc.title_number

    @property
    def track_count(self) -> int:
        return len(self._toc.tracks)

    @property
    def pts_length(self) -> int:
        return self._toc.pts_length

    def open_track(self, track: int) -> "Track":
        if track < 1 or track > len(self._toc.tracks):
            raise DvdaError(f"track {track} out of range")
        return Track(self, track, self._toc.tracks[track - 1])

    def close(self) -> None:
        pass


@dataclass
class Track:
    """A track (reference: dvda_open_track, dvd-audio.c:530-557)."""

    title: Title
    number: int
    span: ifo_mod.TrackSpan

    @property
    def pts_index(self) -> int:
        return self.span.pts_index

    @property
    def pts_length(self) -> int:
        return self.span.pts_length

    @property
    def first_sector(self) -> int:
        return self.span.first_sector

    @property
    def last_sector(self) -> int:
        return self.span.last_sector

    def open_reader(self, use_device: bool | None = None,
                    config: DecodeConfig | None = None) -> "TrackReader":
        ts = self.title.titleset
        dvda = ts.dvda
        config = config if config is not None else dvda.config
        decrypt = None
        if config is None or config.decrypt:
            decrypt = _make_decrypt(dvda.audio_ts_path, dvda.device)
        aob = AOBReader(dvda.audio_ts_path, ts.number, decrypt=decrypt)
        return TrackReader(aob, self, use_device=use_device, config=config)

    def close(self) -> None:
        pass


class TrackReader:
    """Decoded-track access (reference: dvda_open_track_reader/dvda_read,
    dvd-audio.c:597-795).

    The whole track is decoded in one batched pass on first access
    (planner → executor); :meth:`read` then serves interleaved
    RIFF-WAVE-ordered int32 frames from the cache with the same semantics
    as ``dvda_read`` (short final read, 0 at end of stream).
    """

    def __init__(self, aob: AOBReader, track: Track,
                 use_device: bool | None = None,
                 config: DecodeConfig | None = None):
        self.aob = aob
        self.track = track
        self.use_device = use_device
        self.config = config
        self._cursor = 0
        self._probe()

    def _cfg(self) -> DecodeConfig:
        return self.config if self.config is not None else default_config()

    # -- probing (dvda_open_track_reader, dvd-audio.c:597-657) -------------

    def _probe(self) -> None:
        span = self.track.span
        first_batch = self.aob.read_sectors(span.first_sector, 1)
        if first_batch.shape[0] == 0:
            raise DvdaError("track starts past end of AOB space")
        pkt = next(demux_audio_packets(first_batch, span.first_sector), None)
        if pkt is None:
            # scan forward for the first audio packet (degenerate discs)
            more = self.aob.read_sectors(span.first_sector, span.last_sector - span.first_sector + 1)
            for pkt in demux_audio_packets(more, span.first_sector):
                break
            if pkt is None:
                raise DvdaError("no audio packet found in track")
        r = BitReader(pkt.payload)
        codec_id, pad_2_size = read_audio_packet_header(r)
        if codec_id == PCM_CODEC_ID:
            self.codec = "PCM"
            params, _, _ = pcm_codec.parse_pcm_params(r)
            self.parameters = params
        elif codec_id == MLP_CODEC_ID:
            self.codec = "MLP"
            from .codecs.mlp import probe as mlp_probe

            self.parameters = mlp_probe.probe_parameters(self.aob, self.track.span)
        else:
            raise DvdaError(f"unknown codec id {codec_id:#x}")

    # -- stream attributes (dvd-audio.c:665-749) ----------------------------

    @property
    def bits_per_sample(self) -> int:
        return self.parameters.bits_per_sample

    @property
    def sample_rate(self) -> int:
        return self.parameters.sample_rate

    @property
    def channel_count(self) -> int:
        return self.parameters.channel_count

    @property
    def channel_mask(self) -> int:
        return self.parameters.channel_mask

    # -- batched decode ----------------------------------------------------

    @cached_property
    def _decoded(self) -> np.ndarray:
        """Full-track decode: int32 [frames, channels] in RIFF WAVE order."""
        if self.codec == "PCM":
            return self._decode_pcm()
        from .codecs.mlp.track import decode_mlp_track

        return decode_mlp_track(self.aob, self.track.span, self.parameters,
                                use_device=self.use_device,
                                config=self.config)

    def _decode_pcm(self) -> np.ndarray:
        """Batch PCM decode.

        Mirrors decode_pcm_audio's termination (dvd-audio.c:1016-1082):
        packets are consumed while the PTS-derived frame countdown is
        positive and parameters/codec match; all frames of consumed packets
        are emitted.  The PCM path ignores the track's last sector — the
        countdown is the terminator — so packets are pulled sector-batch by
        sector-batch until satisfied.
        """
        span = self.track.span
        # total frames from PTS length (open_pcm_track_reader, :976-979)
        total = round(span.pts_length * self.parameters.sample_rate / PTS_PER_SECOND)
        bps = self.parameters.bits_per_sample
        ch = self.parameters.channel_count
        csize = pcm_codec.chunk_size(bps, ch)
        cfg = self._cfg()
        if cfg.use_native_demux:
            # native packet walk (host/src/demux.cc); the loop below is its
            # executable specification and differential-test oracle
            from . import host

            data = host.assemble_pcm_chunks(self.aob, span.first_sector,
                                            self.parameters, total, csize)
            if data is not None:
                chunks = np.frombuffer(data, dtype=np.uint8)
                return self._unpack_pcm_chunks(
                    chunks.reshape(-1, csize), bps, ch)
        chunk_arrays: list[np.ndarray] = []
        remaining = total
        sector = span.first_sector
        BATCH = cfg.io_batch_sectors  # sectors per host I/O batch
        done = False
        while not done:
            sectors = self.aob.read_sectors(sector, BATCH)
            if sectors.shape[0] == 0:
                break
            for pkt in demux_audio_packets(sectors, sector):
                if pkt is None:
                    done = True
                    break
                r = BitReader(pkt.payload)
                try:
                    codec_id, pad_2_size = read_audio_packet_header(r)
                    if codec_id != PCM_CODEC_ID:
                        done = True
                        break
                    params, _, _ = pcm_codec.parse_pcm_params(r)
                    if params != self.parameters:
                        done = True
                        break
                    r.skip_bytes(pad_2_size - 9)
                except BitstreamError:
                    done = True
                    break
                payload = r.read_bytes(r.size())
                chunks = pcm_codec.payload_to_chunks(payload, bps, ch)
                chunk_arrays.append(chunks)
                remaining -= min(chunks.shape[0] * 2, remaining)
                if remaining == 0:
                    done = True
                    break
            else:
                if sectors.shape[0] < BATCH:
                    break
            sector += sectors.shape[0]
        if not chunk_arrays:
            return np.zeros((0, ch), dtype=np.int32)
        return self._unpack_pcm_chunks(
            np.concatenate(chunk_arrays, axis=0), bps, ch)

    def _unpack_pcm_chunks(self, all_chunks: np.ndarray, bps: int,
                           ch: int) -> np.ndarray:
        # PCM unpack is pure data movement: the vectorised numpy path runs
        # at memcpy speed on the host, so the device kernel only pays off
        # when explicitly requested (e.g. the data is device-resident
        # anyway or host cores are saturated).  Auto mode stays host-side.
        if self.use_device is True:
            from .ops.pcm_unpack import decode_chunks_device

            return np.asarray(decode_chunks_device(all_chunks, bps, ch))
        return pcm_codec.decode_chunks_numpy(all_chunks, bps, ch)

    def _device_enabled(self) -> bool:
        if self.use_device is not None:
            return self.use_device
        return self._cfg().use_device

    # -- pull API (dvda_read, dvd-audio.c:751-795) --------------------------

    def read(self, pcm_frames: int) -> np.ndarray:
        """Return up to ``pcm_frames`` interleaved frames ([n, channels]).

        On MLP tracks with mid-stream resume points the pull API is
        **segment-backed**: only the manifest segment(s) covering the
        cursor are decoded (one stays cached), so sequential pulls and
        seek+read through a multi-hour track run in bounded memory with
        no prefix replay — the reference must decode from the track start.
        Once a whole-track decode has been materialized (read_all), reads
        serve from it instead."""
        if pcm_frames <= 0:
            return np.zeros((0, self.channel_count), dtype=np.int32)
        if "_decoded" not in self.__dict__:
            seg = self._segment_reader()
            if seg is not None:
                out = self._pull_segments(seg, self._cursor,
                                          self._cursor + pcm_frames)
                self._cursor += out.shape[0]
                return out
        data = self._decoded
        out = data[self._cursor : self._cursor + pcm_frames]
        self._cursor += out.shape[0]
        return out

    def _pull_segments(self, seg, pos: int, end: int) -> np.ndarray:
        """Frames [pos, end) via the segment reader (clamped to the
        track; truncates at a corrupt-short segment)."""
        parts = []
        end = min(seg.total_pcm, end)
        while pos < end:
            start, arr = seg.segment(seg.segment_index(pos))
            take = arr[pos - start : end - start]
            if take.shape[0] == 0:
                break  # corrupt-short segment: truncate here
            parts.append(take)
            pos += take.shape[0]
        if not parts:
            return np.zeros((0, self.channel_count), dtype=np.int32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _segment_reader(self):
        """Cached MlpSegmentReader (or None when unsupported / overridden
        to the Python engines / not MLP)."""
        got = getattr(self, "_seg_reader", None)
        if got is None:
            got = False
            # engage only when the batch decode would take a native
            # executor too (decode_mlp_track's gate): never dispatch the
            # device pipeline when both executors are disabled, and keep
            # the use_device=False Python-engines escape hatch
            cfg = self._cfg()
            if (self.codec == "MLP" and self.use_device is not False
                    and cfg.use_native
                    and (self._device_enabled()
                         or cfg.resolved_host_complete())):
                from .codecs.mlp.track import open_mlp_segment_reader

                got = open_mlp_segment_reader(
                    self.aob, self.track.span, self.parameters,
                    30 * self.sample_rate, config=self.config) or False
            self._seg_reader = got
        return got or None

    def read_all(self) -> np.ndarray:
        data = self._decoded
        out = data[self._cursor :]
        self._cursor = data.shape[0]
        return out

    def read_all_packed(self) -> "bytes | bytearray":
        """Whole track as little-endian WAV data bytes (what follows the
        ``data`` chunk header).  On the native 24- and 16-bit MLP paths
        the device (or host-complete reconstruction) packs the bytes
        itself, so this skips two full host passes (unpack to int32 +
        repack) versus ``pack_samples_le(read_all())`` — it is the
        production path for disc→WAV conversion.  May return a
        ``bytearray`` (bytes-compatible for writing, comparison and
        slicing) to avoid copying the whole track once more."""
        from .utils.wav import pack_samples_le

        bps = self.bits_per_sample
        if (self.codec == "PCM" and bps in (16, 24)
                and "_decoded" not in self.__dict__ and self._cursor == 0
                and self._cfg().use_native_demux
                and self.use_device is not True):
            # an explicit use_device=True keeps the device unpack path
            # (the documented "explicitly requested" engine selection)
            out = self._pcm_packed_native()
            if out is not None:
                return out
        if (self.codec == "MLP" and bps in (16, 24)
                and (self._device_enabled()
                     or self._cfg().resolved_host_complete())
                and "_decoded" not in self.__dict__ and self._cursor == 0):
            from .codecs.mlp.track import decode_mlp_track

            out = decode_mlp_track(self.aob, self.track.span,
                                   self.parameters,
                                   use_device=self.use_device,
                                   want_packed=True,
                                   config=self.config)
            if out.dtype == np.uint8:
                self._cursor = out.shape[0]
                self._packed_frames = out.shape[0]
                # a bytearray-backed decode (host-complete reconstruct)
                # is handed over as-is — bytes-compatible for writing,
                # comparison and slicing, no 50 MB+ copy
                base = out.base
                while base is not None:
                    if isinstance(base, memoryview):
                        base = base.obj
                        continue
                    if isinstance(base, bytearray):
                        break
                    base = getattr(base, "base", None)
                if isinstance(base, bytearray) and len(base) == out.nbytes:
                    return base
                return out.tobytes()
            self.__dict__["_decoded"] = out  # fallback decoded int32: keep
        return pack_samples_le(self.read_all(), bps)

    def iter_packed(self, segment_pcm_frames: int | None = None):
        """Stream the track's WAV payload as an iterator of bytes-like
        chunks whose concatenation equals ``read_all_packed()``.

        MLP tracks decode segment-by-segment from manifest resume points
        (codecs/mlp/track.iter_mlp_packed_segments): peak memory is the
        assembled MLP byte stream plus ONE segment's working set, instead
        of whole-track arenas — the way to convert a multi-hour track in
        bounded memory.  ``segment_pcm_frames`` defaults to ~30 seconds.
        Tracks without mid-stream resume points (and PCM tracks, whose
        payload is already within ~2x of the raw sectors) fall back to a
        single chunk.  Does not move the pull cursor."""
        if segment_pcm_frames is None:
            segment_pcm_frames = 30 * self.sample_rate
        # an explicit open_reader(use_device=False) selects the Python
        # engines everywhere (the documented escape hatch) — streaming
        # would route through the native executors, so fall through to
        # the single-chunk path which honors the override
        if (self.codec == "MLP" and "_decoded" not in self.__dict__
                and self.use_device is not False):
            from .codecs.mlp.track import iter_mlp_packed_segments

            it = iter_mlp_packed_segments(self.aob, self.track.span,
                                          self.parameters,
                                          int(segment_pcm_frames),
                                          config=self.config)
            if it is not None:
                return it

        def _whole():
            cursor = self._cursor
            try:
                self._cursor = 0
                data = self.read_all_packed()
            finally:
                self._cursor = cursor
            yield data

        return _whole()

    def _pcm_packed_native(self) -> "bytearray | None":
        """PCM disc→WAV fast path: native demux/assembly straight into WAV
        payload bytes through one composed byte-gather (mp_pcm_repack) —
        the unswap scatter and the LE sample pack are both byte
        permutations, so no int32 round trip is needed.  None → caller
        falls back to the decode + pack_samples_le path (which remains
        the executable spec; parity pinned in test_pcm)."""
        from . import host

        span = self.track.span
        total = round(span.pts_length * self.parameters.sample_rate
                      / PTS_PER_SECOND)
        bps = self.parameters.bits_per_sample
        ch = self.parameters.channel_count
        csize = pcm_codec.chunk_size(bps, ch)
        data = host.assemble_pcm_chunks(self.aob, span.first_sector,
                                        self.parameters, total, csize)
        if data is None:
            return None
        chunks = np.frombuffer(data, dtype=np.uint8)
        n = chunks.size // csize
        if n == 0:
            return None
        chunks = chunks[: n * csize].reshape(n, csize)
        nb = bps // 8
        table = pcm_codec.pcm_gather_indices(bps, ch)[:, :nb].reshape(-1)
        # all frames of consumed packets are emitted (the PTS countdown
        # only stops packet consumption, _decode_pcm's documented
        # semantics) — so the packed output matches read_all() exactly
        # even when the countdown ends mid-packet
        frames = 2 * n
        buf = host.pcm_repack(chunks, table, 2 * ch * nb, frames * ch * nb)
        if buf is None:
            return None
        self._cursor = frames
        self._packed_frames = frames
        return buf

    def read_range(self, start_frame: int, pcm_frames: int) -> np.ndarray:
        """Decode only ``[start_frame, start_frame + pcm_frames)``.

        On the native MLP path this decodes only the manifest segment(s)
        covering the range (the segment reader behind read()) — neither
        the prefix nor the suffix is decoded.  Everywhere else it slices
        the cached full decode.  Does not move the cursor."""
        if self.codec == "MLP" and "_decoded" not in self.__dict__:
            seg = self._segment_reader()
            if seg is not None:
                return self._pull_segments(seg, max(0, start_frame),
                                           start_frame + pcm_frames)
            if (self._device_enabled()
                    or self._cfg().resolved_host_complete()) \
                    and self._cfg().use_native:
                from .codecs.mlp.track import decode_mlp_track_range

                out = decode_mlp_track_range(self.aob, self.track.span,
                                             self.parameters, start_frame,
                                             pcm_frames, config=self.config)
                if out is not None:
                    return out
        return self._decoded[start_frame : start_frame + pcm_frames]

    @property
    def manifest(self):
        """Resume manifest for MLP tracks (None for PCM / host-only paths):
        the frames where decode can start bit-exactly (major sync + clean
        restart), with byte and PCM offsets."""
        if self.codec != "MLP":
            return None
        from .codecs.mlp.track import track_manifest

        return track_manifest(self.aob, self.track.span)

    # -- random access (beyond the reference API) ---------------------------
    # The reference supports only track-granularity seeks (aob_reader_seek
    # + re-probe, dvd-audio.c:616, TODO:63-79).  Batched decode makes
    # sample-accurate intra-track seeking free: position into the cache.

    def seek(self, pcm_frame: int) -> int:
        """Seek to an absolute PCM frame within the track; returns the
        actual (clamped) position.  On segment-backed MLP readers this
        clamps against the manifest total without decoding anything."""
        seg = (None if "_decoded" in self.__dict__
               else self._segment_reader())
        total = seg.total_pcm if seg else self._decoded.shape[0]
        self._cursor = min(max(0, pcm_frame), total)
        return self._cursor

    def tell(self) -> int:
        return self._cursor

    @property
    def total_pcm_frames(self) -> int:
        if "_decoded" not in self.__dict__:
            if getattr(self, "_packed_frames", None) is not None:
                return self._packed_frames  # known from read_all_packed
            seg = self._segment_reader()
            if seg is not None:  # the manifest total, no decode needed
                return seg.total_pcm
        return self._decoded.shape[0]

    def close(self) -> None:
        self.aob.close()


def open_disc(audio_ts_path: str | os.PathLike, device: str | None = None,
              config: DecodeConfig | None = None) -> DVDA:
    return DVDA(audio_ts_path, device, config=config)
