"""Full-disc batch decode (BASELINE config 5) + device C2 kernel tests."""

import os

import numpy as np
import pytest

from dvda.batch import decode_disc, disc_to_wavs
from dvda.cppm.c2 import c2_g
from dvda.cppm.decrypt import CppmDecryptor, encrypt_sectors
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import MlpTrackSpec, PcmTrackSpec, build_disc


def _disc(tmp_path):
    mlp = MlpSynthConfig(channel_assignment=1, n_frames=16, seed=2,
                         bits_per_sample=24, sample_rate=96000)
    return build_disc(str(tmp_path / "AUDIO_TS"), [
        [PcmTrackSpec(pcm_frames=960, seed=1),
         MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                      pcm_frames=mlp.total_pcm_frames,
                      sample_rate=96000, channel_assignment=1)],
        [PcmTrackSpec(pcm_frames=480, seed=9)],
    ])


def test_decode_disc_yields_all_tracks(tmp_path):
    layout = _disc(tmp_path)
    results = list(decode_disc(layout.path, use_device=False))
    assert [(r.title, r.track, r.codec) for r in results] == [
        (1, 1, "PCM"), (1, 2, "MLP"), (2, 1, "PCM")]
    assert results[0].samples.shape == (960, 2)
    assert results[1].samples.shape == (16 * 32, 2)


def test_disc_to_wavs_matches_oracle(tmp_path, ref_oracle):
    layout = _disc(tmp_path)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    written = disc_to_wavs(layout.path, str(tmp_path / "ours"),
                           use_device=False)
    assert sorted(os.path.basename(p) for p in written) == sorted(golden)
    for p in written:
        with open(p, "rb") as f:
            assert f.read() == golden[os.path.basename(p)], p


def test_device_c2_matches_numpy(tmp_path):
    import jax.numpy as jnp

    from dvda.container.aob import AOBReader
    from dvda.ops.c2_decrypt import dcbc_dec_device

    layout = _disc(tmp_path)
    sectors = AOBReader(layout.path, 1).read_sectors(0, 4).copy()
    mk, album = 0x00A5A5A5A5A5A5A5, 0x0F0E0D0C0B0A0908
    enc = encrypt_sectors(sectors, mk, album)
    ref = CppmDecryptor(mk, album, preserve_cci=True,
                        use_device=False).decrypt_sectors(enc)
    dev = CppmDecryptor(mk, album, preserve_cci=True,
                        use_device=True).decrypt_sectors(enc)
    assert np.array_equal(ref, dev)


def test_multi_titleset_disc(tmp_path):
    """A 2-titleset disc (build_disc_multi): the object model addresses
    titleset 2 and decodes it identically to the same tracks written as
    a standalone single-titleset disc; decode_disc covers both sets.
    (The reference CLIs hardcode titleset 1 — dvda2wav.c:83 — but the
    library API, dvda_open_titleset, takes any number.)"""
    from dvda.api import DVDA
    from dvda.testutil.synth import build_disc_multi

    mlp = MlpSynthConfig(channel_assignment=1, n_frames=16, seed=5,
                         bits_per_sample=24, sample_rate=96000)

    def specs():
        return [
            [PcmTrackSpec(pcm_frames=960, seed=7),
             MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                          pcm_frames=mlp.total_pcm_frames,
                          sample_rate=96000, channel_assignment=1)],
        ]

    layouts = build_disc_multi(str(tmp_path / "m" / "AUDIO_TS"), [
        [[PcmTrackSpec(pcm_frames=480, seed=1)]],  # titleset 1
        specs(),                                    # titleset 2
    ])
    assert len(layouts) == 2
    disc = DVDA(layouts[0].path)
    assert disc.titleset_count == 2

    single = build_disc(str(tmp_path / "s" / "AUDIO_TS"), specs())
    ts2 = disc.open_titleset(2).open_title(1)
    ref = DVDA(single.path).open_titleset(1).open_title(1)
    for n in (1, 2):
        a = ts2.open_track(n).open_reader(use_device=False).read_all()
        b = ref.open_track(n).open_reader(use_device=False).read_all()
        assert np.array_equal(a, b), n

    results = list(decode_disc(layouts[0].path, use_device=False))
    assert [(r.titleset, r.title, r.track) for r in results] == [
        (1, 1, 1), (2, 1, 1), (2, 1, 2)]


def test_multi_titleset_split_aobs(tmp_path):
    """Per-titleset AOB chains: each ATS_XX set splits into its own
    ATS_XX_N.AOB files (aob.c:38-47 chaining, per titleset)."""
    import os

    from dvda.api import DVDA
    from dvda.testutil.synth import build_disc_multi

    layouts = build_disc_multi(str(tmp_path / "AUDIO_TS"), [
        [[PcmTrackSpec(pcm_frames=28800, seed=1)]],
        [[PcmTrackSpec(pcm_frames=28800, seed=2)]],
    ], aob_split_sectors=8)
    names = sorted(os.listdir(layouts[0].path))
    assert any(n.startswith("ATS_01_2") for n in names)
    assert any(n.startswith("ATS_02_2") for n in names)
    disc = DVDA(layouts[0].path)
    for ts, seed in ((1, 1), (2, 2)):
        r = (disc.open_titleset(ts).open_title(1).open_track(1)
             .open_reader(use_device=False))
        single = build_disc(str(tmp_path / f"s{ts}" / "AUDIO_TS"),
                            [[PcmTrackSpec(pcm_frames=28800, seed=seed)]])
        rr = (DVDA(single.path).open_titleset(1).open_title(1)
              .open_track(1).open_reader(use_device=False))
        assert np.array_equal(r.read_all(), rr.read_all()), ts
