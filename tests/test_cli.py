"""CLI parity tests: our dvda2wav/dvda-debug-info vs the reference tools."""

import os
import subprocess
import sys

import pytest

from dvda.cli import dvda2wav, dvda_debug_info
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import MlpTrackSpec, PcmTrackSpec, build_disc


def _disc(tmp_path):
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         bits_per_sample=24, sample_rate=96000,
                         n_frames=24, seed=4)
    return build_disc(str(tmp_path / "AUDIO_TS"), [
        [PcmTrackSpec(pcm_frames=960, seed=1),
         MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                      pcm_frames=mlp.total_pcm_frames,
                      sample_rate=96000, channel_assignment=17)],
        [PcmTrackSpec(pcm_frames=480, seed=2, bits_per_sample=24)],
    ])


def test_dvda2wav_matches_reference(tmp_path, ref_oracle, capsys):
    layout = _disc(tmp_path)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    out_dir = str(tmp_path / "ours")
    rc = dvda2wav.main(["-A", layout.path, "-d", out_dir, "--no-device"])
    assert rc == 0
    ours = sorted(os.listdir(out_dir))
    assert ours == sorted(golden)
    for name in ours:
        with open(os.path.join(out_dir, name), "rb") as f:
            assert f.read() == golden[name], name


def test_dvda2wav_title_track_selection(tmp_path, ref_oracle):
    layout = _disc(tmp_path)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"),
                                     title=1, track=2)
    out_dir = str(tmp_path / "ours")
    rc = dvda2wav.main(["-A", layout.path, "-d", out_dir, "-T", "1",
                        "-t", "2", "--no-device"])
    assert rc == 0
    assert sorted(os.listdir(out_dir)) == ["track-01-02.wav"]
    with open(os.path.join(out_dir, "track-01-02.wav"), "rb") as f:
        assert f.read() == golden["track-01-02.wav"]


def test_debug_info_matches_reference(tmp_path, ref_oracle, capsys):
    layout = _disc(tmp_path)
    expected = ref_oracle.run_debug_info(layout.path)
    rc = dvda_debug_info.main(["-A", layout.path])
    assert rc == 0
    assert capsys.readouterr().out == expected


def test_cli_bad_path(capsys):
    assert dvda2wav.main(["-A", "/nonexistent"]) == 1
    assert dvda_debug_info.main(["-A", "/nonexistent"]) == 1


def test_cli_entry_points_run():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    for mod in ("dvda.cli.dvda2wav", "dvda.cli.dvda_debug_info"):
        r = subprocess.run([sys.executable, "-m", mod, "--version"],
                           capture_output=True, text=True, env=env)
        assert r.returncode == 0
        assert "libDVD-Audio" in r.stdout


def test_huffman_compiler_cli(tmp_path, capsys):
    """dvda-huffman (the reference `huffman` build-tool analog,
    huffman.c:588-598): compiles a reference-layout codebook JSON and a
    frequency list; the JSON output round-trips against peek_lut."""
    import json

    import numpy as np

    from dvda.cli import huffman_compile
    from dvda.codecs.mlp.codebooks import CODEBOOKS, peek_lut

    # reference JSON layout: alternating bit arrays and values (<0 invalid)
    flat = []
    for code, value in CODEBOOKS[2]:
        flat.append([int(b) for b in code])
        flat.append(-1 if value is None else value)
    src = tmp_path / "cb2.json"
    src.write_text(json.dumps(flat))

    out = tmp_path / "cb2_tables.json"
    rc = huffman_compile.main(["-i", str(src), "--format", "json",
                               "-o", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    vals, lens = peek_lut(2)
    assert got["bits"] == 9
    assert np.array_equal(np.asarray(got["values"]), vals)
    assert np.array_equal(np.asarray(got["lengths"]), lens)

    # C-header output runs and contains both tables
    rc = huffman_compile.main(["-i", str(src), "--name", "cb2"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "cb2_val[512]" in text and "cb2_len[512]" in text

    # frequency-list mode builds a canonical codebook first
    freqs = tmp_path / "freqs.json"
    freqs.write_text(json.dumps({"0": 10, "1": 5, "2": 1, "3": 1}))
    rc = huffman_compile.main(["--frequencies", str(freqs),
                               "--format", "json"])
    assert rc == 0
    got = json.loads(capsys.readouterr().out)
    lens = {v: l for v, l in zip(got["values"], got["lengths"]) if l}
    assert lens[0] == min(lens.values())  # most frequent value: shortest
