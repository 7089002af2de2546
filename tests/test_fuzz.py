"""Randomised configuration sweep: spec / batched / native engines must
agree on any valid stream the synthesiser can produce, and a sample of
configs is checked byte-for-byte against the reference oracle."""

import random

import numpy as np
import pytest

from dvda import host
from dvda.api import DVDA
from dvda.codecs.mlp.engine import BatchedMlpDecoder
from dvda.codecs.mlp.native_engine import decode_native
from dvda.codecs.mlp.spec import MlpDecoder
from dvda.codecs.params import StreamParameters
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import BPS_CODE, RATE_CODE, MlpTrackSpec, build_disc
from dvda.utils.wav import pack_samples_le, wave_header


def random_config(rng: random.Random) -> MlpSynthConfig:
    assign = rng.choice([0, 1, 2, 4, 6, 7, 12, 17, 18, 20])
    from dvda.codecs.params import unpack_channel_count

    nsub = rng.choice([1, 2]) if unpack_channel_count(assign) >= 3 else 1
    return MlpSynthConfig(
        channel_assignment=assign,
        substream_count=nsub,
        bits_per_sample=rng.choice([16, 24]),
        sample_rate=rng.choice([48000, 96000, 192000, 44100]),
        n_frames=rng.randrange(4, 40),
        blocks_per_frame=rng.randrange(1, 4),
        block_size=rng.choice([8, 12, 16, 40, 64]),
        major_sync_every=rng.choice([1, 2, 8]),
        restart_every=rng.choice([1, 2, 4, 8]),
        checkdata=rng.random() < 0.8,
        end_marker=rng.random() < 0.7,
        fir_across_restart=rng.random() < 0.5,
        seed=rng.randrange(10_000),
    )


def params_of(cfg):
    return StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                            RATE_CODE[cfg.sample_rate], 0xF,
                            cfg.channel_assignment)


@pytest.mark.parametrize("master_seed", [101, 202])
def test_engines_agree_on_random_configs(master_seed):
    rng = random.Random(master_seed)
    for trial in range(12):
        cfg = random_config(rng)
        stream = synth_mlp_stream(cfg)
        params = params_of(cfg)

        spec = MlpDecoder(params)
        n_spec = spec.decode_bytes(stream)
        a = spec.take_frames()
        assert n_spec == cfg.total_pcm_frames, (trial, cfg)

        eng = BatchedMlpDecoder(params)
        n_eng = 0
        step = rng.randrange(500, 2500)
        for off in range(0, len(stream), step):
            n_eng += eng.decode_bytes(stream[off : off + step])
        b = eng.take_frames()
        assert n_eng == n_spec and np.array_equal(a, b), (trial, cfg)

        if host.available():
            c = decode_native(stream, np.zeros(0, np.int64), len(stream),
                              params)
            assert c is not None and np.array_equal(a, c), (trial, cfg)


def test_oracle_parity_on_random_configs(tmp_path, ref_oracle):
    rng = random.Random(42)
    for trial in range(4):
        cfg = random_config(rng)
        stream = synth_mlp_stream(cfg)
        spec = MlpTrackSpec(mlp_stream=stream,
                            pcm_frames=cfg.total_pcm_frames,
                            sample_rate=cfg.sample_rate,
                            channel_assignment=cfg.channel_assignment)
        d = tmp_path / f"t{trial}"
        layout = build_disc(str(d / "AUDIO_TS"), [[spec]])
        golden = ref_oracle.run_dvda2wav(layout.path, str(d / "gold"))
        reader = (DVDA(layout.path).open_titleset(1).open_title(1)
                  .open_track(1).open_reader(use_device=True))
        samples = reader.read_all()
        hdr = wave_header(reader.sample_rate, reader.channel_count,
                          reader.channel_mask, reader.bits_per_sample,
                          samples.shape[0])
        assert hdr + pack_samples_le(samples, reader.bits_per_sample) \
            == golden["track-01-01.wav"], (trial, cfg)


def test_random_corruption_never_crashes():
    """Random byte corruption: engines must degrade identically and never
    raise (the reference crashes/aborts on many of these)."""
    rng = random.Random(7)
    base_cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                              n_frames=16, seed=3)
    stream = bytearray(synth_mlp_stream(base_cfg))
    params = params_of(base_cfg)
    for trial in range(10):
        corrupted = bytearray(stream)
        for _ in range(rng.randrange(1, 5)):
            corrupted[rng.randrange(len(corrupted))] ^= rng.randrange(1, 256)
        spec = MlpDecoder(params)
        spec.decode_bytes(bytes(corrupted))
        a = spec.take_frames()
        if host.available():
            c = decode_native(bytes(corrupted), np.zeros(0, np.int64),
                              len(corrupted), params)
            if c is not None:
                assert np.array_equal(a, c), trial


def test_mt_parse_random_corruption_sweep():
    """Threaded section parse == sequential parse across a sweep of
    randomly-corrupted larger streams (each corruption either lands in a
    frame — exercising the sequential-redo path — or in dead space)."""
    rng = random.Random(303)
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=400, seed=31, major_sync_every=4,
                         restart_every=4, blocks_per_frame=2, block_size=40)
    base = synth_mlp_stream(cfg)
    assert len(base) > 64 << 10
    for trial in range(10):
        data = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            data[rng.randrange(len(data))] ^= rng.randrange(1, 256)
        data = bytes(data)
        seq = host.parse_mlp_stream(data)
        inc = host.parse_mlp_stream_begin(data, threads=4)
        inc.step(0)
        mt = inc.view()
        assert mt.status == seq.status, trial
        if seq.status == 0:
            assert mt.F == seq.F and mt.T == seq.T, trial
            assert np.array_equal(mt.frame_len, seq.frame_len), trial
            assert np.array_equal(mt.noise0, seq.noise0), trial
            for s in range(seq.substream_count):
                assert np.array_equal(mt.sub[s]["residuals"],
                                      seq.sub[s]["residuals"]), (trial, s)
        seq.close()
        inc.close()


def test_devhuff_random_corruption_matches_spec():
    """Random corruption under device_huffman: the skip-values parse drops
    frames (rolling back the split-mode sub_bitpos tables) or the whole
    decode falls back — either way the output must equal the spec decoder
    on the same bytes, and never crash."""
    from dvda.config import DecodeConfig

    if not host.available():
        pytest.skip("native host library unavailable")
    rng = random.Random(17)
    base_cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                              n_frames=24, seed=5, major_sync_every=2,
                              restart_every=2, fir_across_restart=False,
                              params_update_prob=0.0)
    stream = bytearray(synth_mlp_stream(base_cfg))
    params = params_of(base_cfg)
    hc = DecodeConfig(device_huffman=True)
    for trial in range(10):
        corrupted = bytearray(stream)
        for _ in range(rng.randrange(1, 5)):
            corrupted[rng.randrange(len(corrupted))] ^= rng.randrange(1, 256)
        spec = MlpDecoder(params)
        spec.decode_bytes(bytes(corrupted))
        a = spec.take_frames()
        c = decode_native(bytes(corrupted), np.zeros(0, np.int64),
                          len(corrupted), params, config=hc)
        if c is not None:
            assert np.array_equal(a, c), trial
