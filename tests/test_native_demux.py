"""Native demux/assembler (host/src/demux.cc) vs the Python executable
specification (codecs/mlp/track.py:_assemble_stream) — byte equality across
disc shapes, batch boundaries, and corruption."""

import os
import tempfile

import numpy as np
import pytest

from dvda import host
from dvda.api import DVDA
from dvda.codecs.mlp import track as trackmod
from dvda.container.aob import AOBReader
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import MlpTrackSpec, PcmTrackSpec, build_disc

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")


def _mlp_spec(cfg):
    return MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames,
                        sample_rate=cfg.sample_rate,
                        channel_assignment=cfg.channel_assignment)


def _python_assemble(path, tr):
    os.environ["DVDA_DISABLE_NATIVE_DEMUX"] = "1"
    try:
        return trackmod._assemble_stream(AOBReader(path, 1), tr)
    finally:
        del os.environ["DVDA_DISABLE_NATIVE_DEMUX"]


def _mlp_tracks(path):
    title = DVDA(path).open_titleset(1).open_title(1)
    for n in range(1, title.track_count + 1):
        tr = title.open_track(n)
        if tr.open_reader(use_device=False).codec == "MLP":
            yield tr


def _assert_equal(path, tr, batch=4096):
    nat = host.assemble_mlp_stream(AOBReader(path, 1), tr.first_sector,
                                   tr.last_sector, batch=batch)
    py = _python_assemble(path, tr)
    assert (nat is None) == (py is None)
    if nat is None:
        return None
    assert nat[0] == py[0]
    assert np.array_equal(nat[1], py[1])
    assert nat[2] == py[2]
    return nat


def test_multitrack_tail_rule(tmp_path):
    cfgs = [MlpSynthConfig(channel_assignment=1, n_frames=24, seed=s)
            for s in (11, 22, 33)]
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[_mlp_spec(c) for c in cfgs]])
    n = 0
    for tr in _mlp_tracks(layout.path):
        assert _assert_equal(layout.path, tr) is not None
        n += 1
    assert n == 3


def test_two_substream_and_batch_resume(tmp_path):
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=16, seed=3)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[_mlp_spec(cfg)]])
    (tr,) = list(_mlp_tracks(layout.path))
    full = _assert_equal(layout.path, tr)
    # batch=1 exercises the resumable state machine on every sector edge
    one = host.assemble_mlp_stream(AOBReader(layout.path, 1),
                                   tr.first_sector, tr.last_sector, batch=1)
    assert one[0] == full[0] and np.array_equal(one[1], full[1])


def test_codec_mismatch_markers(tmp_path):
    mlp = MlpSynthConfig(channel_assignment=1, n_frames=12, seed=5,
                         bits_per_sample=16, sample_rate=48000)
    layout = build_disc(str(tmp_path / "AUDIO_TS"),
                        [[PcmTrackSpec(pcm_frames=960, seed=1), _mlp_spec(mlp)]])
    for tr in _mlp_tracks(layout.path):
        assert _assert_equal(layout.path, tr) is not None


def test_corrupt_sector_matches_python(tmp_path):
    cfg = MlpSynthConfig(channel_assignment=1, n_frames=200, seed=9)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[_mlp_spec(cfg)]])
    (tr,) = list(_mlp_tracks(layout.path))
    path = os.path.join(layout.path, sorted(
        f for f in os.listdir(layout.path) if f.endswith(".AOB"))[0])
    data = bytearray(open(path, "rb").read())
    assert len(data) > (tr.first_sector + 4) * 2048
    # corrupt a pack header a few sectors into the track body
    mid = (tr.first_sector + 3) * 2048
    data[mid] ^= 0xFF
    open(path, "wb").write(bytes(data))
    _assert_equal(layout.path, tr)  # both cut the stream identically
    # corrupt the very first sector: malformed during probe → both None
    data[tr.first_sector * 2048 + 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert _assert_equal(layout.path, tr) is None


def test_native_demux_feeds_decoder(tmp_path):
    """End-to-end: the assembled stream decodes to the same samples as the
    pure-Python assembly + engines."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=20, seed=7)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[_mlp_spec(cfg)]])
    (tr,) = list(_mlp_tracks(layout.path))
    a = tr.open_reader(use_device=True).read_all()
    os.environ["DVDA_DISABLE_NATIVE_DEMUX"] = "1"
    try:
        b = tr.open_reader(use_device=True).read_all()
    finally:
        del os.environ["DVDA_DISABLE_NATIVE_DEMUX"]
    assert np.array_equal(a, b)


@pytest.mark.parametrize("bps,rate,ch_assign,frames", [
    (16, 48000, 1, 2880), (24, 96000, 17, 2880), (24, 192000, 0, 2880),
    (16, 44100, 12, 2940),  # 44.1k: frames must be a multiple of 49
])
def test_pcm_native_walk_matches_python(tmp_path, bps, rate, ch_assign,
                                        frames):
    spec = PcmTrackSpec(pcm_frames=frames, seed=bps + ch_assign,
                        bits_per_sample=bps, sample_rate=rate,
                        channel_assignment=ch_assign)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]],
                        aob_split_sectors=5)
    track = DVDA(layout.path).open_titleset(1).open_title(1).open_track(1)
    a = track.open_reader(use_device=False).read_all()
    os.environ["DVDA_DISABLE_NATIVE_DEMUX"] = "1"
    try:
        b = track.open_reader(use_device=False).read_all()
    finally:
        del os.environ["DVDA_DISABLE_NATIVE_DEMUX"]
    assert np.array_equal(a, b)
    assert a.shape[0] > 0


def test_pcm_native_walk_corrupt_matches_python(tmp_path):
    spec = PcmTrackSpec(pcm_frames=5760, seed=2)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    track = DVDA(layout.path).open_titleset(1).open_title(1).open_track(1)
    path = os.path.join(layout.path, sorted(
        f for f in os.listdir(layout.path) if f.endswith(".AOB"))[0])
    data = bytearray(open(path, "rb").read())
    data[(track.first_sector + 2) * 2048 + 1] ^= 0xFF
    open(path, "wb").write(bytes(data))
    a = track.open_reader(use_device=False).read_all()
    os.environ["DVDA_DISABLE_NATIVE_DEMUX"] = "1"
    try:
        b = track.open_reader(use_device=False).read_all()
    finally:
        del os.environ["DVDA_DISABLE_NATIVE_DEMUX"]
    assert np.array_equal(a, b)


def test_fuzz_corruption_equality(tmp_path):
    """Seeded random corruption sweep: native assembly/PCM walk must agree
    with the Python specification on arbitrarily damaged discs."""
    rng = np.random.default_rng(2026)
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=24, seed=1)
    specs = [[PcmTrackSpec(pcm_frames=960, seed=3), _mlp_spec(cfg)]]
    base = str(tmp_path / "AUDIO_TS")
    layout = build_disc(base, specs)
    aobs = sorted(f for f in os.listdir(base) if f.endswith(".AOB"))
    clean = {f: open(os.path.join(base, f), "rb").read() for f in aobs}
    title = DVDA(base).open_titleset(1).open_title(1)
    pcm_tr, mlp_tr = title.open_track(1), title.open_track(2)
    for trial in range(8):
        f = aobs[rng.integers(len(aobs))]
        data = bytearray(clean[f])
        for _ in range(int(rng.integers(1, 5))):
            data[int(rng.integers(len(data)))] ^= int(rng.integers(1, 256))
        open(os.path.join(base, f), "wb").write(bytes(data))
        _assert_equal(base, mlp_tr)
        a = pcm_tr.open_reader(use_device=False).read_all()
        os.environ["DVDA_DISABLE_NATIVE_DEMUX"] = "1"
        try:
            b = pcm_tr.open_reader(use_device=False).read_all()
        finally:
            del os.environ["DVDA_DISABLE_NATIVE_DEMUX"]
        assert np.array_equal(a, b), trial
        open(os.path.join(base, f), "wb").write(clean[f])
