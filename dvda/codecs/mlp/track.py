"""MLP track decode orchestration: packet walk + termination semantics.

Reference analogs: open_mlp_track_reader (dvd-audio.c:1094-1149),
decode_mlp_audio (:1151-1227), mlp_data_to_major_sync (:1367-1421).

Termination rules, replicated exactly:

* the stream starts at the first major sync at/after the track's first
  sector (bytes before it are discarded);
* packets from sectors within the track feed the decoder; the stream ends
  when a packet decodes **zero** complete frames (dvda_read's
  ``!pcm_frames_read`` check, dvd-audio.c:770-775), when a packet's codec
  id is not MLP, or when packets run out;
* the first packet from a sector **past** the track's last sector triggers
  the tail rule: bytes (from that packet and as many following MLP packets
  as needed) up to — not including — the *next* major sync are fed, then
  the stream ends; if no sync is ever found, everything but the final
  un-scannable ≤7 bytes is fed (find_major_sync stops when fewer than 8
  bytes remain, dvd-audio.c:1253-1285).
"""

from __future__ import annotations

import numpy as np

from ...config import DecodeConfig, default_config
from ...container.aob import AOBReader
from ..params import StreamParameters
from .probe import find_major_sync, iter_mlp_payloads
from .spec import MlpDecoder

__all__ = ["decode_mlp_track", "decode_mlp_track_range", "track_manifest",
           "iter_mlp_packed_segments", "MlpSegmentReader",
           "open_mlp_segment_reader"]


def decode_mlp_track(
    aob: AOBReader,
    span,
    parameters: StreamParameters,
    use_device: bool | None = None,
    want_packed: bool = False,
    config: DecodeConfig | None = None,
) -> np.ndarray:
    """Decode a whole MLP track to int32 [frames, channels] (WAVE order).

    With ``want_packed`` the native 24-/16-bit paths may instead return
    uint8 [frames, channels*(3 or 2)] little-endian WAV data bytes (the
    device packs them); callers must check the dtype — every fallback
    returns int32."""
    cfg = config if config is not None else default_config()
    if use_device is None:
        use_device = cfg.use_device
    # the native path serves both executors: device pipeline, or the
    # host-complete reconstruction when configured (an explicit
    # ``use_device=False`` argument still selects the Python engines —
    # config-level host_complete/DISABLE_DEVICE selects host-complete)
    if cfg.use_native and (use_device or cfg.resolved_host_complete()):
        out = _try_native(aob, span, parameters, want_packed, cfg)
        if out is not None:
            return out
    return _decode_python(aob, span, parameters, use_device)


def _try_native(aob: AOBReader, span, parameters,
                want_packed: bool = False,
                config: DecodeConfig | None = None) -> np.ndarray | None:
    """Single-pass assembly + native parse + device pipeline; ``None`` to
    fall back to the Python engines."""
    from ...utils.profiling import global_timer
    from .native_engine import decode_native

    with global_timer.stage("mlp/assemble"):
        assembled = _assemble_stream(aob, span, config)
    if assembled is None:
        return None
    stream, boundaries, probe_end = assembled
    if not stream:
        return np.zeros((0, parameters.channel_count), dtype=np.int32)
    return decode_native(stream, boundaries, probe_end, parameters,
                         want_packed=want_packed, config=config)


def _parse_with_manifest(aob: AOBReader, span,
                         config: DecodeConfig | None = None,
                         skip_values: bool = False):
    """Assemble + parse + build the resume manifest; ``None`` if the native
    path is unavailable.  Returns (stream, boundaries, probe_end, manifest,
    end_byte) — end_byte is the stream offset where the last kept frame
    ends.  ``skip_values`` uses the length-only parse (no residual arenas
    — the manifest needs only geometry), the right mode when the caller
    decodes separately (iter_mlp_packed_segments)."""
    from ... import host
    from .manifest import build_manifest
    from .native_engine import _frame_cut

    if not host.available():
        return None
    cfg = config if config is not None else default_config()
    assembled = _assemble_stream(aob, span, cfg)
    if assembled is None:
        return None
    stream, boundaries, probe_end = assembled
    if not stream:
        return None
    inc = host.parse_mlp_stream_begin(
        stream, skip_values=skip_values,
        threads=cfg.resolved_parse_threads())
    if inc is None:
        return None
    try:
        inc.step(0)
        parse = inc.view()
        if parse.status != 0:
            return None
        F = _frame_cut(parse.frame_end,
                       np.asarray(boundaries, dtype=np.int64), probe_end)
        manifest = build_manifest(stream, parse, F)
        end_byte = int(parse.frame_end[F - 1]) if F else 0
    finally:
        inc.close()
    return stream, boundaries, probe_end, manifest, end_byte


def iter_mlp_packed_segments(aob: AOBReader, span,
                             parameters: StreamParameters,
                             segment_pcm_frames: int,
                             config: DecodeConfig | None = None):
    """Stream the track's WAV payload in bounded segments.

    The reference decodes incrementally (dvda_read pulls frames); the
    rebuild's batch decode materializes whole-track arenas, which for
    multi-hour tracks is gigabytes.  This is the constant-working-set
    path: a *skip-values* parse (length-only, no residual arenas) builds
    the resume manifest, the track is cut at manifest points into
    segments of >= ``segment_pcm_frames``, and each segment — a clean
    restart, so it decodes standalone bit-exactly — runs the normal
    native decode on its own slice.  Peak memory is the assembled MLP
    byte stream (~1/10 of the WAV) plus ONE segment's working set.

    Returns a generator of bytes-like payload chunks whose concatenation
    equals ``read_all_packed()``, or ``None`` when streaming is
    unsupported (native path unavailable, parse bail, or a bit layout
    whose segments don't byte-align) — callers fall back to the batch
    decode.
    """
    from ...utils.log import logger as log
    from ...utils.wav import pack_samples_le
    from .native_engine import decode_native

    cfg = config if config is not None else default_config()
    if not cfg.use_native:
        return None
    # manifest from a skip-values parse: length-only, no residual arenas
    got = _parse_with_manifest(aob, span, cfg, skip_values=True)
    if got is None:
        return None
    stream, _boundaries, _probe_end, manifest, end_byte = got
    if manifest.total_frames == 0 or not manifest.points:
        return None

    pcm0, offs = _segment_cuts(manifest, segment_pcm_frames, end_byte)
    bps = parameters.bits_per_sample
    ch = parameters.channel_count
    # bit-packed widths (20-bit) must byte-align at every cut
    if any((p * ch * bps) % 8 for p in pcm0):
        return None

    def gen():
        for i in range(len(pcm0) - 1):
            o0, o1 = offs[i], offs[i + 1]
            # a manifest point is a clean restart + major sync: the slice
            # decodes standalone, bit-identically to the same frames
            # inside the full-track decode
            seg = stream[o0:o1]
            out = decode_native(seg, np.zeros(0, dtype=np.int64), 0,
                                parameters, want_packed=True, config=cfg)
            if out is None:
                # pathological slice: the pure-Python spec decoder is the
                # always-correct fallback for just this segment
                dec = MlpDecoder(parameters)
                dec.decode_bytes(seg)
                out = dec.take_frames()
            want = pcm0[i + 1] - pcm0[i]
            short = out.shape[0] < want
            out = out[:want]
            if out.dtype == np.uint8:
                yield out.tobytes()
            else:
                yield pack_samples_le(out, bps)
            if short:
                # the segment decoded fewer frames than its geometry says
                # (mid-track corruption): stop here, matching the batch
                # path's truncate-at-the-damage semantics — never leave a
                # silent hole between segments
                log.warning("iter_packed: segment %d decoded %d/%d frames;"
                            " stream truncated", i, out.shape[0], want)
                return

    return gen()


def _segment_cuts(manifest, segment_pcm_frames: int, end_byte: int):
    """Manifest-aligned segment boundaries ≥ ``segment_pcm_frames``
    apart: (pcm0, offs) with the end sentinels appended — the ONE
    cut-point policy shared by iter_mlp_packed_segments and
    MlpSegmentReader so the streaming and pull paths always slice the
    stream identically."""
    cuts = [manifest.points[0]]
    for p in manifest.points[1:]:
        if p.pcm_frame - cuts[-1].pcm_frame >= segment_pcm_frames:
            cuts.append(p)
    pcm0 = [p.pcm_frame for p in cuts] + [manifest.total_pcm_frames]
    offs = [p.byte_offset for p in cuts] + [end_byte]
    return pcm0, offs


class MlpSegmentReader:
    """Random-access decode over manifest cut points: the pull-API
    backend for bounded-memory reads.  Holds the assembled byte stream
    plus ONE decoded segment (int32, WAVE order) at a time; any
    read/seek position decodes just its segment — no prefix replay, no
    whole-track arenas.  Segment boundaries and decode mechanics are
    shared with iter_mlp_packed_segments (same slices, same executors,
    bit-identical output)."""

    def __init__(self, stream, pcm0, offs, parameters, cfg):
        self._stream = stream
        self._pcm0 = pcm0  # cut frames + total sentinel (_segment_cuts)
        self._offs = offs  # cut byte offsets + end sentinel
        self.total_pcm = pcm0[-1]
        self._parameters = parameters
        self._cfg = cfg
        self._cache_i = -1
        self._cache = None

    def segment_index(self, pcm: int) -> int:
        import bisect

        return max(0, bisect.bisect_right(self._pcm0, pcm) - 1)

    def segment(self, i: int):
        """(first_pcm_frame, int32 samples [n, ch]) of segment ``i``."""
        if i == self._cache_i:
            return self._pcm0[i], self._cache
        from .native_engine import decode_native

        seg = self._stream[self._offs[i] : self._offs[i + 1]]
        out = decode_native(seg, np.zeros(0, dtype=np.int64), 0,
                            self._parameters, config=self._cfg)
        if out is None:
            dec = MlpDecoder(self._parameters)
            dec.decode_bytes(seg)
            out = dec.take_frames()
        out = out[: self._pcm0[i + 1] - self._pcm0[i]]
        self._cache_i, self._cache = i, out
        return self._pcm0[i], out


def open_mlp_segment_reader(aob: AOBReader, span,
                            parameters: StreamParameters,
                            segment_pcm_frames: int,
                            config: DecodeConfig | None = None):
    """Build an :class:`MlpSegmentReader`, or ``None`` when unsupported
    (native path unavailable / parse bail / empty track)."""
    cfg = config if config is not None else default_config()
    if not cfg.use_native:
        return None
    got = _parse_with_manifest(aob, span, cfg, skip_values=True)
    if got is None:
        return None
    stream, _boundaries, _probe_end, manifest, end_byte = got
    if manifest.total_frames == 0 or not manifest.points:
        return None
    pcm0, offs = _segment_cuts(manifest, segment_pcm_frames, end_byte)
    return MlpSegmentReader(stream, pcm0, offs, parameters, cfg)


def track_manifest(aob: AOBReader, span, config: DecodeConfig | None = None):
    """The track's resume manifest (codecs/mlp/manifest.py), or ``None``
    when the native path is unavailable."""
    got = _parse_with_manifest(aob, span, config, skip_values=True)
    return got[3] if got is not None else None


def decode_mlp_track_range(
    aob: AOBReader,
    span,
    parameters: StreamParameters,
    start_pcm: int,
    n_pcm: int,
    config: DecodeConfig | None = None,
) -> np.ndarray | None:
    """Decode only PCM frames [start_pcm, start_pcm + n_pcm) by resuming at
    the nearest manifest point — the prefix is never decoded (SURVEY §5
    checkpoint/resume; the reference can only re-decode from the track
    start).  ``None`` falls back to a full decode + slice."""
    got = _parse_with_manifest(aob, span, config, skip_values=True)
    if got is None:
        return None
    stream, boundaries, probe_end, manifest, _end = got
    if not manifest.points:
        return None  # zero kept frames: let the caller's fallback decide
    rp = manifest.resume_for_pcm_frame(start_pcm)
    from .native_engine import decode_native

    if rp.byte_offset:
        boundaries = np.asarray(boundaries, dtype=np.int64)
        boundaries = boundaries[boundaries > rp.byte_offset] - rp.byte_offset
        probe_end = max(0, probe_end - rp.byte_offset)
        stream = stream[rp.byte_offset:]
    out = decode_native(stream, boundaries, probe_end, parameters,
                        config=config)
    if out is None:
        return None
    lo = start_pcm - rp.pcm_frame
    return out[lo : lo + n_pcm]


def _assemble_stream(aob: AOBReader, span, config: DecodeConfig | None = None):
    """Collect the exact byte stream the pull decoder would feed, plus the
    post-probe packet boundaries (for the zero-frame-packet cut) and the
    probe-prefix length.  Mirrors the loop in :func:`_decode_python`.

    The native demux/assembler (host/src/demux.cc) is the production path
    — the Python loop below is its executable specification and the
    fallback when no toolchain is available (or via
    ``DVDA_DISABLE_NATIVE_DEMUX=1`` for differential testing)."""
    cfg = config if config is not None else default_config()
    if cfg.use_native_demux:
        from ... import host

        native = host.assemble_mlp_stream(aob, span.first_sector,
                                          span.last_sector)
        if native is not None:
            return native
        if host.available():
            return None  # malformed during probe: Python decode path
    payloads = iter_mlp_payloads(aob, span.first_sector)
    buf = bytearray()
    off = -1
    for item in payloads:
        if item is None:
            return None  # malformed container: let the python path decide
        _sector, payload = item
        if payload is None:
            continue
        buf += payload
        off = find_major_sync(bytes(buf))
        if off >= 0 and len(buf) - off >= 18:
            break
    if off < 0:
        return b"", np.zeros(0, np.int64), 0
    stream = bytearray(buf[off:])
    probe_end = len(stream)
    boundaries: list[int] = []
    for item in payloads:
        if item is None:
            break
        sector, payload = item
        if sector > span.last_sector:
            if payload is None:
                break  # codec mismatch on the boundary packet: nothing fed
            tail = bytearray(payload)
            while True:
                o2 = find_major_sync(bytes(tail))
                if o2 >= 0:
                    stream += tail[:o2]
                    break
                nxt = next(payloads, None)
                if nxt is None:
                    stream += tail[: max(0, len(tail) - 7)]
                    break
                _s2, p2 = nxt
                if p2 is None:
                    continue  # non-MLP packets skipped in the tail scan
                tail += p2
            break
        if payload is None:
            break  # codec mismatch within the track ends the stream
        stream += payload
        boundaries.append(len(stream))
    return bytes(stream), np.asarray(boundaries, dtype=np.int64), probe_end


def _decode_python(
    aob: AOBReader,
    span,
    parameters: StreamParameters,
    use_device: bool | None,
) -> np.ndarray:
    decoder = _make_decoder(parameters, use_device)
    payloads = iter_mlp_payloads(aob, span.first_sector)

    # -- probe: discard bytes before the first major sync ------------------
    buf = bytearray()
    off = -1
    for item in payloads:
        if item is None:
            return decoder.take_frames()
        _sector, payload = item
        if payload is None:
            continue  # non-MLP packets skipped while probing
        buf += payload
        off = find_major_sync(bytes(buf))
        if off >= 0 and len(buf) - off >= 18:
            break
    if off < 0:
        return decoder.take_frames()

    # initial feed: everything from the sync onward; result ignored
    # (open_mlp_track_reader, dvd-audio.c:1136-1140)
    decoder.decode_bytes(bytes(buf[off:]))

    # -- main loop ---------------------------------------------------------
    for item in payloads:
        if item is None:
            break
        sector, payload = item
        if sector > span.last_sector:
            _feed_tail(decoder, payload, payloads)
            break
        if payload is None:
            break  # codec mismatch within the track ends the stream
        if decoder.decode_bytes(payload) == 0:
            break  # a packet yielding no complete frames ends the stream
    return decoder.take_frames()


def _feed_tail(decoder, first_payload, payloads) -> None:
    """Feed bytes up to the next major sync (mlp_data_to_major_sync)."""
    if first_payload is None:
        return  # codec mismatch on the boundary packet: nothing fed
    tail = bytearray(first_payload)
    while True:
        off = find_major_sync(bytes(tail))
        if off >= 0:
            decoder.decode_bytes(bytes(tail[:off]))
            return
        item = next(payloads, None)
        if item is None:  # exhausted, or the malformed-stream sentinel
            break
        _sector, payload = item
        if payload is None:
            continue  # non-MLP packets skipped in the tail scan
        tail += payload
    fed = max(0, len(tail) - 7)
    decoder.decode_bytes(bytes(tail[:fed]))


def _make_decoder(parameters: StreamParameters, use_device: bool | None):
    """Choose the decode engine: batched device engine or sequential spec."""
    if use_device is None:
        use_device = default_config().use_device
    if use_device:
        try:
            from .engine import BatchedMlpDecoder

            return BatchedMlpDecoder(parameters)
        except ImportError:
            pass
    return MlpDecoder(parameters)
