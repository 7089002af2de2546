"""MLP codec tests: spec-decoder round trips, codebook tables, and
end-to-end WAV byte parity vs the reference dvda2wav oracle."""

import numpy as np
import pytest

from dvda.api import DVDA
from dvda.bitstream import BitReader
from dvda.codecs.mlp.codebooks import (
    CODEBOOKS,
    decode_tree,
    encode_map,
    peek_lut,
)
from dvda.codecs.mlp.probe import find_major_sync
from dvda.codecs.mlp.spec import MlpDecoder
from dvda.codecs.params import StreamParameters
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import BPS_CODE, RATE_CODE, MlpTrackSpec, build_disc
from dvda.utils.wav import pack_samples_le, wave_header


def stream_params(cfg: MlpSynthConfig) -> StreamParameters:
    return StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                            RATE_CODE[cfg.sample_rate], 0xF,
                            cfg.channel_assignment)


# ---------------------------------------------------------------- codebooks

def test_codebooks_are_prefix_free():
    for k, entries in CODEBOOKS.items():
        codes = [c for c, _ in entries]
        assert len(set(codes)) == len(codes)
        for a in codes:
            for b in codes:
                if a is not b:
                    assert not b.startswith(a) or a == b, (k, a, b)


def test_codebooks_are_complete():
    # every codebook must cover all 512 9-bit patterns exactly once
    for k in CODEBOOKS:
        values, lengths = peek_lut(k)
        covered = np.zeros(512, dtype=bool)
        for code, value in CODEBOOKS[k]:
            n = len(code)
            p = int(code, 2) << (9 - n)
            assert not covered[p : p + (1 << (9 - n))].any()
            covered[p : p + (1 << (9 - n))] = True
        assert covered.all()


def test_peek_lut_matches_tree():
    for k in CODEBOOKS:
        values, lengths = peek_lut(k)
        tree = decode_tree(k)
        for pattern in range(512):
            data = bytes([(pattern >> 1) & 0xFF, (pattern & 1) << 7])
            r = BitReader(data)
            if lengths[pattern] == 0:
                with pytest.raises(Exception):
                    r.read_huffman_code(tree)
            else:
                assert r.read_huffman_code(tree) == values[pattern]
                assert r.getpos() == lengths[pattern]


def test_encode_decode_roundtrip():
    for k in CODEBOOKS:
        tree = decode_tree(k)
        for value, (code, length) in encode_map(k).items():
            data = (code << (16 - length)).to_bytes(2, "big")
            assert BitReader(data).read_huffman_code(tree) == value


# ------------------------------------------------------------- spec decoder

CONFIGS = [
    # (assignment, substreams, bits, rate)
    (1, 1, 24, 96000),    # stereo, BASELINE config 3
    (17, 2, 24, 96000),   # 5.1 2-substream, BASELINE config 4
    (1, 1, 16, 48000),
    (12, 2, 24, 192000),
    (0, 1, 16, 44100),    # mono
    (6, 1, 24, 88200),    # 5ch single substream
    (1, 1, 20, 96000),    # 20-bit output path
]


@pytest.mark.parametrize("assign,nsub,bits,rate", CONFIGS)
def test_spec_decoder_roundtrip(assign, nsub, bits, rate):
    cfg = MlpSynthConfig(channel_assignment=assign, substream_count=nsub,
                         bits_per_sample=bits, sample_rate=rate,
                         n_frames=24, seed=assign * 7 + nsub)
    dec = MlpDecoder(stream_params(cfg))
    n = dec.decode_bytes(synth_mlp_stream(cfg))
    assert n == cfg.total_pcm_frames
    out = dec.take_frames()
    assert out.shape == (cfg.total_pcm_frames, cfg.channels)


def test_decoder_handles_split_feeds():
    """Frames split across arbitrary feed boundaries decode identically."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2, n_frames=16,
                         seed=3)
    stream = synth_mlp_stream(cfg)
    whole = MlpDecoder(stream_params(cfg))
    whole.decode_bytes(stream)
    a = whole.take_frames()

    split = MlpDecoder(stream_params(cfg))
    rng = np.random.default_rng(0)
    pos = 0
    while pos < len(stream):
        step = int(rng.integers(1, 700))
        split.decode_bytes(stream[pos : pos + step])
        pos += step
    b = split.take_frames()
    assert np.array_equal(a, b)


def test_corrupt_crc_drops_frame():
    cfg = MlpSynthConfig(channel_assignment=1, n_frames=8, seed=9,
                         major_sync_every=1, restart_every=1)
    stream = bytearray(synth_mlp_stream(cfg))
    # corrupt a byte inside the second frame's substream data
    total0 = (((stream[0] & 0x0F) << 8) | stream[1]) * 2
    stream[total0 + 40] ^= 0xFF
    dec = MlpDecoder(stream_params(cfg))
    n = dec.decode_bytes(bytes(stream))
    # one frame dropped, the rest decode
    assert n == cfg.total_pcm_frames - cfg.frames_per_mlp_frame


def test_find_major_sync_offsets():
    cfg = MlpSynthConfig(channel_assignment=1, n_frames=2, seed=1)
    stream = synth_mlp_stream(cfg)
    assert find_major_sync(stream) == 0
    assert find_major_sync(b"\x12\x34" + stream) == 2
    assert find_major_sync(b"\x00" * 7) == -1


# --------------------------------------------------------- oracle parity

def _mlp_disc(tmp_path, cfgs):
    tracks = []
    for cfg in cfgs:
        tracks.append(
            MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                         pcm_frames=cfg.total_pcm_frames,
                         sample_rate=cfg.sample_rate,
                         channel_assignment=cfg.channel_assignment)
        )
    return build_disc(str(tmp_path / "AUDIO_TS"), [tracks])


@pytest.mark.parametrize("assign,nsub,bits,rate", CONFIGS)
def test_mlp_wav_parity_vs_oracle(tmp_path, ref_oracle, assign, nsub, bits, rate):
    cfg = MlpSynthConfig(channel_assignment=assign, substream_count=nsub,
                         bits_per_sample=bits, sample_rate=rate,
                         n_frames=40, seed=assign + nsub * 100)
    layout = _mlp_disc(tmp_path, [cfg])
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    reader = (DVDA(layout.path).open_titleset(1).open_title(1)
              .open_track(1).open_reader(use_device=False))
    assert reader.codec == "MLP"
    assert reader.sample_rate == rate
    assert reader.bits_per_sample == bits
    samples = reader.read_all()
    hdr = wave_header(rate, reader.channel_count, reader.channel_mask,
                      bits, samples.shape[0])
    assert hdr + pack_samples_le(samples, bits) == golden["track-01-01.wav"]


def test_mlp_multitrack_parity(tmp_path, ref_oracle):
    """Track boundaries exercise the sector-limit + next-major-sync tail
    rule (decode_mlp_audio, dvd-audio.c:1167-1194)."""
    cfgs = [
        MlpSynthConfig(channel_assignment=1, n_frames=24, seed=s,
                       bits_per_sample=24, sample_rate=96000)
        for s in (11, 22, 33)
    ]
    layout = _mlp_disc(tmp_path, cfgs)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    title = DVDA(layout.path).open_titleset(1).open_title(1)
    for n in range(1, 4):
        reader = title.open_track(n).open_reader(use_device=False)
        samples = reader.read_all()
        hdr = wave_header(reader.sample_rate, reader.channel_count,
                          reader.channel_mask, reader.bits_per_sample,
                          samples.shape[0])
        ours = hdr + pack_samples_le(samples, reader.bits_per_sample)
        assert ours == golden[f"track-01-{n:02d}.wav"], f"track {n}"


def test_mixed_pcm_mlp_disc(tmp_path, ref_oracle):
    from dvda.testutil.synth import PcmTrackSpec

    mlp = MlpSynthConfig(channel_assignment=1, n_frames=24, seed=5,
                         bits_per_sample=16, sample_rate=48000)
    tracks = [
        PcmTrackSpec(pcm_frames=960, seed=1),
        MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                     pcm_frames=mlp.total_pcm_frames,
                     sample_rate=48000, channel_assignment=1),
    ]
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [tracks])
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    title = DVDA(layout.path).open_titleset(1).open_title(1)
    for n, codec in [(1, "PCM"), (2, "MLP")]:
        reader = title.open_track(n).open_reader(use_device=False)
        assert reader.codec == codec
        samples = reader.read_all()
        hdr = wave_header(reader.sample_rate, reader.channel_count,
                          reader.channel_mask, reader.bits_per_sample,
                          samples.shape[0])
        ours = hdr + pack_samples_le(samples, reader.bits_per_sample)
        assert ours == golden[f"track-01-{n:02d}.wav"], f"track {n}"


def test_generic_codebook_compiler():
    from dvda.codecs.mlp.codebooks import compile_entries

    vals, lens = compile_entries([("0", 5), ("10", 6), ("11", None)])
    assert vals[0b00] == 5 and lens[0b00] == 1
    assert vals[0b10] == 6 and lens[0b10] == 2
    assert vals[0b11] == -1 and lens[0b11] == 0
    with pytest.raises(ValueError):
        compile_entries([("0", 1), ("01", 2)])  # overlap


def test_load_reference_codebook_json(tmp_path):
    """Our canonical tables must equal a compile of the reference's JSON
    codebooks loaded through the generic path."""
    import json
    import os

    from dvda.codecs.mlp.codebooks import (
        compile_entries,
        load_codebook_json,
        peek_lut,
    )

    ref_dir = "/root/reference/src"
    if not os.path.isdir(ref_dir):
        pytest.skip("reference sources unavailable")
    for k in (1, 2, 3):
        entries = load_codebook_json(os.path.join(ref_dir, f"mlp_codebook{k}.json"))
        vals, lens = compile_entries(entries, 9)
        v2, l2 = peek_lut(k)
        assert np.array_equal(vals, v2) and np.array_equal(lens, l2), k


def test_build_codebook_from_frequencies():
    """Runtime frequency-list Huffman building (reference huffman.c:262-353
    analog): canonical, prefix-free, optimal-length, round-trips."""
    from dvda.codecs.mlp.codebooks import build_codebook, compile_entries

    freqs = {0: 45, 1: 13, 2: 12, 3: 16, 4: 9, 5: 5}
    entries = build_codebook(freqs)
    # compiles cleanly → prefix-free
    vals, lens = compile_entries(entries)
    # classic huffman example: expected code lengths 1,3,3,3,4,4
    got = sorted(len(c) for c, _ in entries)
    assert got == [1, 3, 3, 3, 4, 4]
    # most frequent value gets the shortest code
    by_value = {v: c for c, v in entries}
    assert len(by_value[0]) == 1
    # every code decodes back through the generic LUT
    for code, value in entries:
        pattern = int(code, 2) << (max(got) - len(code))
        assert vals[pattern] == value and lens[pattern] == len(code)
    # degenerate cases
    assert build_codebook({}) == []
    assert build_codebook({7: 3}) == [("0", 7)]


def test_bitreader_bigint_fields():
    """>64-bit field reads (reference mini-gmp read_bigint analog,
    bitstream.h:176-186) — Python ints are arbitrary precision."""
    from dvda.bitstream import BitReader, BitWriter

    big = (1 << 150) - 0xDEADBEEF
    w = BitWriter()
    w.write(3, 5)
    w.write(151, big)
    w.byte_align()
    r = BitReader(w.getvalue())
    assert r.read(3) == 5
    assert r.read_bigint(151) == big
