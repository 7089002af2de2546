"""Resume manifest + mid-track partial decode (SURVEY §5 checkpoint/resume).

The reference can only re-decode a track from its start; the rebuild's
manifest marks every frame where decode can resume bit-exactly (major sync
+ clean restart, no FIR coupling) and `read_range` decodes from the nearest
one — asserted equal to slices of the full decode."""

import numpy as np
import pytest

from dvda import host
from dvda.api import DVDA
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import MlpTrackSpec, build_disc

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")


def _disc(tmp_path, **kw):
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         bits_per_sample=24, sample_rate=96000,
                         n_frames=32, major_sync_every=4, restart_every=4,
                         seed=13, **kw)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames,
                        sample_rate=96000, channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    return (DVDA(layout.path).open_titleset(1).open_title(1).open_track(1),
            cfg)


def test_manifest_structure(tmp_path):
    track, cfg = _disc(tmp_path, fir_across_restart=False,
                       params_update_prob=0.0)
    reader = track.open_reader(use_device=True)
    m = reader.manifest
    assert m is not None
    assert m.total_frames == cfg.n_frames
    # aligned major syncs + restarts every 4 frames → a point every 4 frames
    frames = [p.frame for p in m.points]
    assert frames == list(range(0, cfg.n_frames, 4))
    assert m.points[0].byte_offset == 0 and m.points[0].pcm_frame == 0
    per = cfg.frames_per_mlp_frame
    for p in m.points:
        assert p.pcm_frame == p.frame * per
    # lookup picks the latest point at or before the target
    assert m.resume_for_pcm_frame(0).frame == 0
    assert m.resume_for_pcm_frame(9 * per).frame == 8
    assert m.resume_for_pcm_frame(10**9).frame == frames[-1]


def test_read_range_matches_full_decode(tmp_path):
    track, cfg = _disc(tmp_path, fir_across_restart=False,
                       params_update_prob=0.0)
    full = track.open_reader(use_device=True).read_all()
    reader = track.open_reader(use_device=True)
    per = cfg.frames_per_mlp_frame
    for start, n in [(0, per), (5 * per, 3 * per), (4 * per + 7, 10),
                     (cfg.total_pcm_frames - 5, 99)]:
        got = reader.read_range(start, n)
        assert np.array_equal(got, full[start : start + n]), (start, n)
    # read_range must not disturb the pull cursor
    assert reader.tell() == 0


def test_fir_coupling_blocks_resume(tmp_path):
    """With FIR state crossing restarts only frame 0 is a resume point —
    and partial reads still decode correctly (full-prefix fallback)."""
    track, cfg = _disc(tmp_path, fir_across_restart=True)
    reader = track.open_reader(use_device=True)
    m = reader.manifest
    assert [p.frame for p in m.points] == [0]
    full = track.open_reader(use_device=True).read_all()
    got = reader.read_range(200, 50)
    assert np.array_equal(got, full[200:250])


def test_pcm_track_has_no_manifest(tmp_path):
    from dvda.testutil.synth import PcmTrackSpec

    layout = build_disc(str(tmp_path / "AUDIO_TS"),
                        [[PcmTrackSpec(pcm_frames=960, seed=1)]])
    reader = (DVDA(layout.path).open_titleset(1).open_title(1)
              .open_track(1).open_reader(use_device=False))
    assert reader.manifest is None
    assert np.array_equal(reader.read_range(10, 20),
                          reader.read_all()[10:30])


def test_read_range_host_complete_resumes(tmp_path):
    """Under the host-complete config (no device), read_range still takes
    the manifest-resume native path — not a full decode + slice — and
    matches the full decode."""
    from dvda.config import DecodeConfig

    track, cfg = _disc(tmp_path, fir_across_restart=False,
                       params_update_prob=0.0)
    full = track.open_reader(use_device=True).read_all()
    reader = (DVDA(str(tmp_path / "AUDIO_TS"),
                   config=DecodeConfig(use_device=False))
              .open_titleset(1).open_title(1).open_track(1).open_reader())
    per = cfg.frames_per_mlp_frame
    for start, n in [(5 * per, 3 * per), (4 * per + 7, 10)]:
        got = reader.read_range(start, n)
        assert np.array_equal(got, full[start : start + n]), (start, n)
    # the range path must not have materialized the full decode
    assert "_decoded" not in reader.__dict__


def test_iter_packed_segments_match_batch(tmp_path):
    """iter_packed streams manifest-aligned segments whose concatenation
    equals read_all_packed, with more than one segment, under both
    executors."""
    from dvda.config import DecodeConfig

    track, cfg = _disc(tmp_path, fir_across_restart=False,
                       params_update_prob=0.0)
    per = cfg.frames_per_mlp_frame
    for dc in (DecodeConfig(use_device=False), None):
        t = (DVDA(str(tmp_path / "AUDIO_TS"), config=dc)
             .open_titleset(1).open_title(1).open_track(1))
        full = bytes(t.open_reader().read_all_packed())
        segs = [bytes(s) for s in
                t.open_reader().iter_packed(segment_pcm_frames=8 * per)]
        assert len(segs) > 1
        assert b"".join(segs) == full


def test_iter_packed_falls_back_to_single_chunk(tmp_path):
    """FIR coupling leaves frame 0 as the only resume point: iter_packed
    still yields the exact payload (one segment covering the track)."""
    track, _cfg = _disc(tmp_path, fir_across_restart=True)
    full = bytes(track.open_reader().read_all_packed())
    segs = [bytes(s) for s in
            track.open_reader().iter_packed(segment_pcm_frames=64)]
    assert b"".join(segs) == full


def test_cli_stream_flag_byte_identical(tmp_path):
    """dvda2wav --stream writes byte-identical WAVs via the segment
    iterator (placeholder header rewritten after the single pass)."""
    from dvda.cli.dvda2wav import main as dvda2wav_main

    _disc(tmp_path, fir_across_restart=False, params_update_prob=0.0)
    a = tmp_path / "batch"
    b = tmp_path / "stream"
    a.mkdir(), b.mkdir()
    assert dvda2wav_main(["-A", str(tmp_path / "AUDIO_TS"),
                          "-d", str(a)]) == 0
    assert dvda2wav_main(["-A", str(tmp_path / "AUDIO_TS"),
                          "-d", str(b), "--stream"]) == 0
    wa = (a / "track-01-01.wav").read_bytes()
    wb = (b / "track-01-01.wav").read_bytes()
    assert wa == wb


def test_iter_packed_segment_bail_uses_spec_decoder(tmp_path, monkeypatch):
    """A per-segment native-decode bail falls back to the pure-Python
    spec decoder for that segment only — the stream stays byte-exact."""
    import dvda.codecs.mlp.native_engine as ne
    from dvda.config import DecodeConfig

    track, cfg = _disc(tmp_path, fir_across_restart=False,
                       params_update_prob=0.0)
    per = cfg.frames_per_mlp_frame
    t = (DVDA(str(tmp_path / "AUDIO_TS"), config=DecodeConfig(use_device=False))
         .open_titleset(1).open_title(1).open_track(1))
    full = bytes(t.open_reader().read_all_packed())

    real = ne.decode_native
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # second segment: force the bail path
            return None
        return real(*a, **kw)

    monkeypatch.setattr(ne, "decode_native", flaky)
    segs = [bytes(s) for s in
            t.open_reader().iter_packed(segment_pcm_frames=8 * per)]
    assert calls["n"] >= 2 and len(segs) > 1
    assert b"".join(segs) == full


def test_segment_backed_pull_reads(tmp_path):
    """read()/seek() on an MLP track decode only the manifest segment(s)
    covering the cursor — no whole-track materialization — and match the
    full decode exactly, including reads spanning segment boundaries."""
    track, cfg = _disc(tmp_path, fir_across_restart=False,
                       params_update_prob=0.0)
    full = track.open_reader(use_device=True).read_all()
    per = cfg.frames_per_mlp_frame
    r = track.open_reader(use_device=True)
    # force small segments so boundaries are crossed
    from dvda.codecs.mlp.track import open_mlp_segment_reader

    r._seg_reader = open_mlp_segment_reader(
        r.aob, r.track.span, r.parameters, 8 * per, config=r.config)
    assert r._seg_reader is not None
    assert len(r._seg_reader._offs) > 2  # multiple segments
    got = [r.read(5), r.read(9 * per), r.read(3)]  # spans a boundary
    assert r.tell() == 5 + 9 * per + 3
    r.seek(20 * per + 7)
    got.append(r.read(10))
    joined = np.concatenate(got[:3])
    assert np.array_equal(joined, full[: joined.shape[0]])
    assert np.array_equal(got[3], full[20 * per + 7 : 20 * per + 17])
    assert "_decoded" not in r.__dict__  # never materialized
    assert r.total_pcm_frames == full.shape[0]
    # reading past the end terminates cleanly
    r.seek(full.shape[0] - 2)
    assert r.read(10).shape[0] == 2
    assert r.read(10).shape[0] == 0


def test_seek_first_stays_bounded(tmp_path):
    """seek()/total_pcm_frames on a FRESH reader open the segment reader
    (manifest totals) instead of materializing the whole-track decode."""
    track, cfg = _disc(tmp_path, fir_across_restart=False,
                       params_update_prob=0.0)
    full = track.open_reader(use_device=True).read_all()
    per = cfg.frames_per_mlp_frame
    r = track.open_reader(use_device=True)
    assert r.total_pcm_frames == full.shape[0]
    assert r.seek(12 * per + 3) == 12 * per + 3
    got = r.read(7)
    assert np.array_equal(got, full[12 * per + 3 : 12 * per + 10])
    assert "_decoded" not in r.__dict__
