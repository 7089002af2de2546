"""Host-complete executor tests: native parse + mp_reconstruct.

The host-complete path runs the decode's math stages — AR filter
(mlp.c:1243-1306), rematrix (:1308-1358), output shifts + WAVE mapping
(:514-533) and WAV byte packing — entirely in the native runtime, with no
device kernels and no host<->device transfers.  It is the production
executor when no accelerator is attached or the device link is slower
than host compute; these tests pin its contract: byte-identical output to
the Python spec decoder (itself oracle-parity tested) and to the device
pipeline, across packing widths, plus the auto-selection and bail
semantics.
"""

import logging

import numpy as np
import pytest

from dvda import host
from dvda.api import DVDA
from dvda.codecs.mlp.native_engine import decode_native
from dvda.codecs.mlp.spec import MlpDecoder
from dvda.codecs.params import StreamParameters
from dvda.config import DecodeConfig
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import BPS_CODE, RATE_CODE, MlpTrackSpec, build_disc
from dvda.utils.profiling import global_timer
from dvda.utils.wav import pack_samples_le, wave_header

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")

HC = DecodeConfig(host_complete=True, use_device=False)


def stream_params(cfg):
    return StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                            RATE_CODE[cfg.sample_rate], 0xF,
                            cfg.channel_assignment)


CONFIGS = [
    (1, 1), (17, 2), (12, 2), (0, 1), (6, 1), (20, 2),
]


@pytest.mark.parametrize("assign,nsub", CONFIGS)
@pytest.mark.parametrize("seed", [0, 3])
def test_host_complete_matches_spec(assign, nsub, seed):
    cfg = MlpSynthConfig(channel_assignment=assign, substream_count=nsub,
                         n_frames=24, seed=seed)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                      config=HC)
    assert b is not None and b.dtype == np.int32
    assert np.array_equal(a, b)


@pytest.mark.parametrize("assign,nsub", [(1, 1), (17, 2), (12, 2)])
def test_host_complete_packed_24(assign, nsub):
    """want_packed on a 24-bit stream: uint8 [T, C*3] little-endian WAV
    payload bytes, identical to packing the int32 samples on the host."""
    cfg = MlpSynthConfig(channel_assignment=assign, substream_count=nsub,
                         n_frames=24, seed=1)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    ref = pack_samples_le(spec.take_frames(), 24)
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                      want_packed=True, config=HC)
    assert b is not None and b.dtype == np.uint8
    assert b.shape[1] == params.channel_count * 3
    assert b.tobytes() == ref


def test_host_complete_packed_16():
    cfg = MlpSynthConfig(channel_assignment=1, bits_per_sample=16,
                         sample_rate=48000, n_frames=24, seed=2)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    ref = pack_samples_le(spec.take_frames(), 16)
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                      want_packed=True, config=HC)
    assert b is not None and b.dtype == np.uint8 and b.tobytes() == ref


def test_host_complete_nonuniform_and_coupled():
    """Block-size switch mid-stream (sectioned geometry) and FIR state
    carried across restarts both reconstruct bit-identically."""
    base = dict(channel_assignment=17, substream_count=2)
    c1 = MlpSynthConfig(blocks_per_frame=2, block_size=32, n_frames=8,
                        seed=11, **base)
    c2 = MlpSynthConfig(blocks_per_frame=2, block_size=64, n_frames=8,
                        seed=12, **base)
    for stream in [synth_mlp_stream(c1) + synth_mlp_stream(c2),
                   synth_mlp_stream(MlpSynthConfig(
                       restart_every=2, major_sync_every=2, n_frames=16,
                       seed=7, **base))]:
        params = stream_params(c1)
        spec = MlpDecoder(params)
        spec.decode_bytes(stream)
        a = spec.take_frames()
        b = decode_native(stream, np.zeros(0, np.int64), len(stream),
                          params, config=HC)
        assert b is not None and np.array_equal(a, b)


def test_reconstruct_frame_cut():
    """mp_reconstruct honors the n_frames cut: decoding the first k
    frames equals the prefix of the full decode (the dvda_read frame-cut
    contract, reference dvd-audio.c:1712-1765)."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=16, seed=5)
    stream = synth_mlp_stream(cfg)
    parse = host.parse_mlp_stream(stream)
    assert parse.status == 0
    from dvda.codecs.mlp.native_engine import _wave_perm
    perm = _wave_perm(parse, 6)
    full = parse.reconstruct(parse.F, 6, 0, perm)
    for k in (1, 7, parse.F):
        part = parse.reconstruct(k, 6, 0, perm)
        t = int(parse.frame_len[:k].sum())
        assert np.array_equal(part, full[:t])
    parse.close()


def test_track_auto_selects_host_complete(tmp_path):
    """With use_device=False in the config, the track decode runs the
    native host-complete executor (not the ~1000x slower Python spec):
    the 'mlp/host-recon' stage fires, and output matches the default
    (device/CPU-jax) path byte for byte."""
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=32, seed=9)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                        pcm_frames=mlp.total_pcm_frames,
                        sample_rate=96000, channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])

    def read(config):
        r = (DVDA(layout.path, config=config).open_titleset(1)
             .open_title(1).open_track(1).open_reader())
        data = r.read_all_packed()
        r.close()
        return data

    default = read(None)  # device pipeline (CPU jax under tests)
    global_timer.reset()
    hc = read(DecodeConfig(use_device=False))  # auto: host-complete
    assert "mlp/host-recon" in global_timer.totals
    assert "mlp/native-parse" in global_timer.totals
    assert hc == default


def test_explicit_reader_flag_still_selects_python(tmp_path):
    """open_reader(use_device=False) — the argument, not the config —
    keeps selecting the Python engines (back-compat for tests/debugging);
    config-level use_device=False selects host-complete instead."""
    mlp = MlpSynthConfig(channel_assignment=1, n_frames=8, seed=3)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                        pcm_frames=mlp.total_pcm_frames,
                        sample_rate=96000, channel_assignment=1)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    r = (DVDA(layout.path).open_titleset(1).open_title(1).open_track(1)
         .open_reader(use_device=False))
    global_timer.reset()
    out = r.read_all()
    r.close()
    assert "mlp/host-recon" not in global_timer.totals
    assert out.shape[1] == 2


def test_host_complete_wav_parity_vs_oracle(tmp_path, ref_oracle):
    """End-to-end: host-complete decode of a synthesized 5.1/24/96k disc
    is byte-identical to the reference dvda2wav's WAV output."""
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=48, seed=13)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                        pcm_frames=mlp.total_pcm_frames,
                        sample_rate=96000, channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    r = (DVDA(layout.path, config=DecodeConfig(use_device=False))
         .open_titleset(1).open_title(1).open_track(1).open_reader())
    payload = r.read_all_packed()
    hdr = wave_header(r.sample_rate, r.channel_count, r.channel_mask,
                      r.bits_per_sample, len(payload) // (r.channel_count * 3))
    r.close()
    assert hdr + payload == golden["track-01-01.wav"]


def test_host_complete_bail_falls_back(tmp_path, caplog):
    """A native-parse bail under host-complete logs the reason and falls
    back to the Python engines — the decode still succeeds."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=32, seed=7, major_sync_every=8,
                         restart_every=8, blocks_per_frame=2, block_size=40)
    stream = bytearray(synth_mlp_stream(cfg))
    stream[40] ^= 0x5A  # frame 0 CRC-dropped; frame 1 lacks a restart
    stream = bytes(stream)
    params = stream_params(cfg)
    with caplog.at_level(logging.WARNING, logger="dvda"):
        out = decode_native(stream, np.zeros(0, np.int64), len(stream),
                            params, config=HC)
    assert out is None  # track.py then falls back to the Python engines
    assert any("native MLP parse bailed" in r.getMessage()
               for r in caplog.records)
    spec = MlpDecoder(params)  # the fallback target still decodes it
    spec.decode_bytes(stream)
    assert spec.take_frames().shape[0] > 0


def test_resolved_host_complete_auto(monkeypatch):
    """Auto-selection routes on MEASURED link speed, not platform names
   : a fast-link mock selects the device pipeline
    and a slow-link mock selects host-complete, regardless of what the
    platform is called; a failed probe (no device) falls back to
    host-complete; an explicit pin always wins."""
    from dvda import config as cfgmod

    assert DecodeConfig(host_complete=True).resolved_host_complete()
    assert not DecodeConfig(host_complete=False,
                            use_device=False).resolved_host_complete()
    assert DecodeConfig(use_device=False).resolved_host_complete()
    # fast link (PCIe-class) -> device pipeline, whatever the platform
    monkeypatch.setenv("DVDA_LINK_MBPS", "16000")
    assert not DecodeConfig().resolved_host_complete()
    # slow link (relay-class) -> host-complete, whatever the platform
    monkeypatch.setenv("DVDA_LINK_MBPS", "40")
    assert DecodeConfig().resolved_host_complete()
    assert not DecodeConfig(host_complete=False).resolved_host_complete()
    # exactly at the threshold counts as fast (strict <)
    monkeypatch.setenv("DVDA_LINK_MBPS",
                       str(cfgmod._LINK_THRESHOLD_MBPS))
    assert not DecodeConfig().resolved_host_complete()
    # probe failure (no usable device backend) -> host path always works
    monkeypatch.delenv("DVDA_LINK_MBPS")
    monkeypatch.setattr(cfgmod, "measured_link_MBps", lambda: None)
    assert DecodeConfig().resolved_host_complete()


def test_measured_link_probe_real_backend(monkeypatch):
    """The probe itself returns a sane figure on the session's default
    backend (CPU in tests: host-local memcpy, far above the threshold)
    and caches per process."""
    from dvda import config as cfgmod

    monkeypatch.delenv("DVDA_LINK_MBPS", raising=False)
    cfgmod._link_probe_cache.clear()
    mbps = cfgmod.measured_link_MBps()
    assert mbps is not None and mbps > cfgmod._LINK_THRESHOLD_MBPS
    assert cfgmod._link_probe_cache["value"] == mbps
    assert cfgmod.measured_link_MBps() == mbps  # cached


def test_reconstruct_rejects_bad_args():
    cfg = MlpSynthConfig(channel_assignment=1, n_frames=4, seed=0)
    stream = synth_mlp_stream(cfg)
    parse = host.parse_mlp_stream(stream)
    assert parse.status == 0
    perm = np.array([0, 1], dtype=np.int32)
    with pytest.raises(ValueError):
        parse.reconstruct(parse.F, 2, 20, perm)  # unsupported pack width
    with pytest.raises(ValueError):
        parse.reconstruct(parse.F, 3, 0, perm)  # perm shape mismatch
    parse.close()


def test_read_all_packed_returns_buffer_without_copy(tmp_path):
    """The host-complete packed decode hands back the reconstruction's
    own bytearray (no whole-track tobytes copy); content equals the
    Python-spec packing and it behaves like bytes for write/compare."""
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=16, seed=21)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                        pcm_frames=mlp.total_pcm_frames,
                        sample_rate=96000, channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    r = (DVDA(layout.path, config=DecodeConfig(use_device=False))
         .open_titleset(1).open_title(1).open_track(1).open_reader())
    packed = r.read_all_packed()
    r.close()
    assert isinstance(packed, bytearray)
    r2 = (DVDA(layout.path, config=DecodeConfig(use_device=False))
          .open_titleset(1).open_title(1).open_track(1).open_reader())
    unpacked = r2.read_all()
    r2.close()
    assert packed == pack_samples_le(unpacked, 24)


def test_arena_pool_recycles_and_clears():
    """The native large-block pool recycles parse arenas across decodes
    (same output bit-for-bit) and pool_clear() empties it; decode still
    works right after a clear."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=24, seed=5)
    stream = synth_mlp_stream(cfg)
    perm = np.arange(6, dtype=np.int32)

    def run():
        parse = host.parse_mlp_stream(stream)
        assert parse.status == 0
        out = parse.reconstruct(parse.F, 6, 24, perm)
        parse.close()
        return bytes(out)

    first = run()
    # second decode reuses pooled arenas (uninitialized memory on the
    # pool's fast path) — output must be identical
    assert run() == first
    host.pool_clear()
    assert run() == first


@pytest.mark.parametrize("threads", [2, 4])
def test_reconstruct_threads_bit_identical(threads):
    """Threaded reconstruction (substream-parallel AR filter +
    frame-range-parallel rematrix/pack) is bit-identical to the serial
    path, packed and unpacked."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=40, seed=31, params_update_prob=0.4)
    stream = synth_mlp_stream(cfg)
    parse = host.parse_mlp_stream(stream)
    assert parse.status == 0
    perm = np.arange(6, dtype=np.int32)
    for pb in (0, 24, 16):
        serial = parse.reconstruct(parse.F, 6, pb, perm)
        par = parse.reconstruct(parse.F, 6, pb, perm, threads=threads)
        assert np.array_equal(serial, par), pb
    parse.close()


def test_host_complete_20bit_wav_parity_vs_oracle(tmp_path, ref_oracle):
    """20-bit MLP under host-complete: reconstruct returns int32 (pack
    on host via utils/wav, like the device path) and the WAV is
    byte-identical to the reference dvda2wav."""
    mlp = MlpSynthConfig(channel_assignment=1, substream_count=1,
                         bits_per_sample=20, n_frames=40, seed=17)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                        pcm_frames=mlp.total_pcm_frames,
                        sample_rate=96000, channel_assignment=1)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    r = (DVDA(layout.path, config=DecodeConfig(use_device=False))
         .open_titleset(1).open_title(1).open_track(1).open_reader())
    global_timer.reset()
    payload = r.read_all_packed()
    assert "mlp/host-recon" in global_timer.totals  # host-complete engaged
    # 20-bit payloads are bit-packed (2.5 B/sample): recover the frame
    # count from bits; wave_header reproduces the reference's quirky
    # bits//8 size fields itself
    frames = len(payload) * 8 // (r.channel_count * r.bits_per_sample)
    hdr = wave_header(r.sample_rate, r.channel_count, r.channel_mask,
                      r.bits_per_sample, frames)
    r.close()
    assert hdr + payload == golden["track-01-01.wav"]


def test_arena_pool_disabled_still_decodes():
    """DVDA_HOST_POOL_MB=0 disables pooling (every block straight to
    new/delete) without changing output bytes.  Subprocess: the cap is
    read once per process."""
    import subprocess
    import sys

    import os

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from dvda import host
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                     n_frames=12, seed=5)
stream = synth_mlp_stream(cfg)
perm = np.arange(6, dtype=np.int32)
outs = []
for _ in range(2):
    p = host.parse_mlp_stream(stream)
    assert p.status == 0
    outs.append(bytes(p.reconstruct(p.F, 6, 24, perm)))
    p.close()
assert outs[0] == outs[1]
host.pool_clear()
print("OK", len(outs[0]))
""".format(repo=repo_root)
    env = dict(os.environ, DVDA_HOST_POOL_MB="0", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")
