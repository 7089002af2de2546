"""Batched MLP engine vs the sequential spec decoder, and end-to-end
device-path parity vs the reference oracle."""

import numpy as np
import pytest

from dvda.api import DVDA
from dvda.codecs.mlp.engine import BatchedMlpDecoder
from dvda.codecs.mlp.spec import MlpDecoder
from dvda.codecs.params import StreamParameters
from dvda.ops.lfsr import lfsr_sequence, noise_pair
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import BPS_CODE, RATE_CODE, MlpTrackSpec, build_disc
from dvda.utils.wav import pack_samples_le, wave_header


def stream_params(cfg):
    return StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                            RATE_CODE[cfg.sample_rate], 0xF,
                            cfg.channel_assignment)


def decode_both(cfg, chunk=1900):
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    n1 = spec.decode_bytes(stream)
    a = spec.take_frames()
    eng = BatchedMlpDecoder(params)
    n2 = sum(eng.decode_bytes(stream[o : o + chunk])
             for o in range(0, len(stream), chunk))
    b = eng.take_frames()
    return n1, a, n2, b, eng


CONFIGS = [
    dict(channel_assignment=1, substream_count=1),
    dict(channel_assignment=17, substream_count=2),
    dict(channel_assignment=12, substream_count=2),
    dict(channel_assignment=0, substream_count=1),
    dict(channel_assignment=6, substream_count=1),
]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_matches_spec(kw, seed):
    cfg = MlpSynthConfig(n_frames=24, seed=seed, **kw)
    n1, a, n2, b, eng = decode_both(cfg)
    assert eng._spec is None, "fast path unexpectedly bailed"
    assert n1 == n2
    assert np.array_equal(a, b)


def test_engine_matches_spec_coupled_chains():
    """Frequent restarts with FIR reuse exercise chain merging."""
    cfg = MlpSynthConfig(channel_assignment=1, substream_count=1,
                         n_frames=32, restart_every=2, major_sync_every=2,
                         seed=5)
    n1, a, n2, b, eng = decode_both(cfg)
    assert eng._spec is None
    assert n1 == n2 and np.array_equal(a, b)


def test_engine_matches_spec_big_blocks():
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=12, blocks_per_frame=1, block_size=64,
                         seed=8)
    n1, a, n2, b, eng = decode_both(cfg)
    assert eng._spec is None
    assert n1 == n2 and np.array_equal(a, b)


def test_engine_matches_spec_on_corrupt_stream():
    """Corruption triggers frame drops; engine and spec must agree."""
    cfg = MlpSynthConfig(channel_assignment=1, n_frames=12, seed=9,
                         major_sync_every=1, restart_every=1)
    stream = bytearray(synth_mlp_stream(cfg))
    total0 = (((stream[0] & 0x0F) << 8) | stream[1]) * 2
    stream[total0 + 40] ^= 0xFF
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(bytes(stream))
    a = spec.take_frames()
    eng = BatchedMlpDecoder(params)
    eng.decode_bytes(bytes(stream))
    b = eng.take_frames()
    assert np.array_equal(a, b)


def test_engine_device_path_vs_oracle(tmp_path, ref_oracle):
    """Full API with use_device=True (batched engine) vs dvda2wav bytes."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         bits_per_sample=24, sample_rate=96000,
                         n_frames=40, seed=42)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames,
                        sample_rate=96000, channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    reader = (DVDA(layout.path).open_titleset(1).open_title(1)
              .open_track(1).open_reader(use_device=True))
    samples = reader.read_all()
    hdr = wave_header(reader.sample_rate, reader.channel_count,
                      reader.channel_mask, reader.bits_per_sample,
                      samples.shape[0])
    assert hdr + pack_samples_le(samples, reader.bits_per_sample) \
        == golden["track-01-01.wav"]


def test_lfsr_jump_matches_scalar():
    seed = 0x5A5A5A
    seq = lfsr_sequence(seed, 500)
    s = np.uint32(seed)
    for i in range(500):
        assert seq[i] == s
        sh = (int(s) >> 7) & 0xFFFF
        s = np.uint32(((int(s) << 16) & 0xFFFFFFFF) ^ sh ^ (sh << 5))


def test_noise_pair_final_seed():
    n0, n1, final = noise_pair(0x123456, 100, 2)
    seq = lfsr_sequence(0x123456, 101)
    assert final == seq[100]
