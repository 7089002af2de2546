"""Device (jitted) PCM unpack vs numpy reference, plus the device path
through the public API."""

import numpy as np
import pytest

from dvda.api import DVDA
from dvda.codecs.pcm import chunk_size, decode_chunks_numpy
from dvda.ops.pcm_unpack import decode_chunks_device
from dvda.testutil.synth import PcmTrackSpec, build_disc


@pytest.mark.parametrize("bits", [16, 24, 20])
@pytest.mark.parametrize("channels", [1, 2, 6])
def test_device_matches_numpy(bits, channels):
    rng = np.random.default_rng(0)
    chunks = rng.integers(0, 256, size=(64, chunk_size(bits, channels)), dtype=np.uint8)
    ref = decode_chunks_numpy(chunks, bits, channels)
    got = np.asarray(decode_chunks_device(chunks, bits, channels))
    assert np.array_equal(ref, got)


def test_api_device_path(tmp_path):
    spec = PcmTrackSpec(pcm_frames=960, seed=11, channel_assignment=17,
                        bits_per_sample=24, sample_rate=96000)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    t = DVDA(layout.path).open_titleset(1).open_title(1).open_track(1)
    host = t.open_reader(use_device=False).read_all()
    dev = t.open_reader(use_device=True).read_all()
    assert np.array_equal(host, dev)
