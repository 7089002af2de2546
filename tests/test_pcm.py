"""PCM codec tests: numpy/vectorised unpack vs the reference scalar
algorithm, and end-to-end WAV byte parity vs the dvda2wav oracle."""

import numpy as np
import pytest

from dvda.api import DVDA
from dvda.codecs.pcm import (
    AOB_BYTE_SWAP,
    chunk_size,
    decode_chunks_numpy,
    pcm_gather_indices,
)
from dvda.codecs.params import riff_wave_channel_mask
from dvda.testutil.synth import PcmTrackSpec, build_disc
from dvda.utils.wav import wave_header, pack_samples_le


def scalar_reference_decode(chunk: bytes, bits_per_sample: int, channels: int):
    """Literal transcription of pcm.c:147-166 for test comparison
    (with unswapped[] zero-initialised — our defined 20-bit semantics)."""
    bps = 0 if bits_per_sample == 16 else 1
    bytes_per_sample = bits_per_sample // 8
    swap = AOB_BYTE_SWAP[bps][channels - 1]
    unswapped = bytearray(40)
    for i, b in enumerate(chunk):
        unswapped[swap[i]] = b
    out = []
    for i in range(channels * 2):
        s = unswapped[i * bytes_per_sample :]
        if bits_per_sample == 16:
            v = (s[1] << 8) | s[0]
            v = v - 0x10000 if s[1] & 0x80 else v
        else:
            v = (s[2] << 16) | (s[1] << 8) | s[0]
            v = v - 0x1000000 if s[2] & 0x80 else v
        out.append(v)
    return out


@pytest.mark.parametrize("bits", [16, 24, 20])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 6])
def test_vectorised_matches_scalar(bits, channels):
    rng = np.random.default_rng(42)
    csize = chunk_size(bits, channels)
    chunks = rng.integers(0, 256, size=(17, csize), dtype=np.uint8)
    got = decode_chunks_numpy(chunks, bits, channels)  # [34, ch]
    for n in range(chunks.shape[0]):
        ref = scalar_reference_decode(bytes(chunks[n]), bits, channels)
        # ref order: slot i -> channel i % ch, frame i // ch
        for i, v in enumerate(ref):
            assert got[2 * n + (i // channels), i % channels] == v, (n, i)


@pytest.mark.parametrize("bits,channels", [(16, 2), (24, 2), (16, 6), (24, 6)])
def test_gather_indices_are_permutation(bits, channels):
    idx = pcm_gather_indices(bits, channels)
    csize = chunk_size(bits, channels)
    used = idx[idx >= 0]
    assert sorted(used.tolist()) == list(range(csize))


CONFIGS = [
    # (bits, rate, channel_assignment)  — BASELINE configs 1 and 2
    (16, 48000, 1),
    (24, 192000, 1),
    (24, 96000, 17),   # 5.1
    (16, 96000, 12),   # 6ch
    (16, 44100, 0),    # mono
]


@pytest.mark.parametrize("bits,rate,assign", CONFIGS)
def test_pcm_wav_parity_vs_oracle(tmp_path, ref_oracle, bits, rate, assign):
    # keep pts_length integral: 90000/rate must divide evenly into frames
    frames = {44100: 2940, 48000: 2880, 96000: 2880, 192000: 5760}[rate]
    spec = PcmTrackSpec(pcm_frames=frames, sample_rate=rate,
                        bits_per_sample=bits, channel_assignment=assign, seed=7)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    assert golden, "oracle produced no output"

    dvda = DVDA(layout.path)
    reader = dvda.open_titleset(1).open_title(1).open_track(1).open_reader(use_device=False)
    assert reader.codec == "PCM"
    assert reader.sample_rate == rate
    assert reader.bits_per_sample == bits
    samples = reader.read_all()
    assert samples.shape == (frames, spec.channels)

    header = wave_header(rate, spec.channels, riff_wave_channel_mask(assign),
                         bits, samples.shape[0])
    ours = header + pack_samples_le(samples, bits)
    theirs = golden["track-01-01.wav"]
    assert ours == theirs


def test_pcm_multitrack_parity(tmp_path, ref_oracle):
    specs = [[PcmTrackSpec(pcm_frames=960, seed=i, channel_assignment=1)
              for i in range(3)]]
    layout = build_disc(str(tmp_path / "AUDIO_TS"), specs)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    dvda = DVDA(layout.path)
    title = dvda.open_titleset(1).open_title(1)
    for n in range(1, 4):
        reader = title.open_track(n).open_reader(use_device=False)
        samples = reader.read_all()
        header = wave_header(reader.sample_rate, reader.channel_count,
                             reader.channel_mask, reader.bits_per_sample,
                             samples.shape[0])
        ours = header + pack_samples_le(samples, reader.bits_per_sample)
        assert ours == golden[f"track-01-{n:02d}.wav"], f"track {n}"


def test_read_pull_semantics(tmp_path):
    spec = PcmTrackSpec(pcm_frames=960, seed=5)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    reader = (DVDA(layout.path).open_titleset(1).open_title(1)
              .open_track(1).open_reader(use_device=False))
    a = reader.read(100)
    assert a.shape == (100, 2)
    rest = reader.read_all()
    assert rest.shape == (860, 2)
    assert reader.read(10).shape == (0, 2)


@pytest.mark.parametrize("bits,assign", [(16, 1), (24, 1), (24, 17)])
def test_read_all_packed_native_repack_parity(tmp_path, bits, assign):
    """The PCM packed fast path (native demux + mp_pcm_repack byte
    gather) equals pack_samples_le(read_all()) and returns its buffer
    without a copy (bytearray)."""
    from dvda import host

    if not host.available():
        pytest.skip("native host library unavailable")
    spec = PcmTrackSpec(pcm_frames=2880, sample_rate=96000,
                        bits_per_sample=bits, channel_assignment=assign,
                        seed=9)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    title = DVDA(layout.path).open_titleset(1).open_title(1)
    packed = title.open_track(1).open_reader().read_all_packed()
    assert isinstance(packed, bytearray)
    samples = title.open_track(1).open_reader().read_all()
    assert bytes(packed) == pack_samples_le(samples, bits)
