"""Native (C++ parse + fused device pipeline) MLP path tests."""

import numpy as np
import pytest

from dvda import host
from dvda.api import DVDA
from dvda.codecs.mlp.native_engine import decode_native, _frame_cut
from dvda.codecs.mlp.spec import MlpDecoder
from dvda.codecs.params import StreamParameters
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
from dvda.testutil.synth import BPS_CODE, RATE_CODE, MlpTrackSpec, build_disc
from dvda.utils.wav import pack_samples_le, wave_header

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")


def stream_params(cfg):
    return StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                            RATE_CODE[cfg.sample_rate], 0xF,
                            cfg.channel_assignment)


CONFIGS = [
    (1, 1), (17, 2), (12, 2), (0, 1), (6, 1), (20, 2),
]


@pytest.mark.parametrize("assign,nsub", CONFIGS)
@pytest.mark.parametrize("seed", [0, 3])
def test_native_matches_spec(assign, nsub, seed):
    cfg = MlpSynthConfig(channel_assignment=assign, substream_count=nsub,
                         n_frames=24, seed=seed)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
    assert b is not None
    assert np.array_equal(a, b)


def test_native_matches_spec_coupled_and_bigblocks():
    for kw in [dict(restart_every=2, major_sync_every=2),
               dict(blocks_per_frame=1, block_size=64)]:
        cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                             n_frames=16, seed=7, **kw)
        stream = synth_mlp_stream(cfg)
        params = stream_params(cfg)
        spec = MlpDecoder(params)
        spec.decode_bytes(stream)
        a = spec.take_frames()
        b = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
        assert b is not None and np.array_equal(a, b), kw


def test_native_corrupt_frame_dropped_like_spec():
    cfg = MlpSynthConfig(channel_assignment=1, n_frames=12, seed=9,
                         major_sync_every=1, restart_every=1)
    stream = bytearray(synth_mlp_stream(cfg))
    total0 = (((stream[0] & 0x0F) << 8) | stream[1]) * 2
    stream[total0 + 40] ^= 0xFF
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(bytes(stream))
    a = spec.take_frames()
    b = decode_native(bytes(stream), np.zeros(0, np.int64), len(stream), params)
    assert b is not None and np.array_equal(a, b)


def test_frame_cut_semantics():
    # frames end at bytes 100, 200, 300; probe covers to 50
    ends = np.array([100, 200, 300], dtype=np.int64)
    # packets: (50,150] has 1 end, (150,250] has 1, (250,400] has 1 -> all kept
    assert _frame_cut(ends, np.array([150, 250, 400], np.int64), 50) == 3
    # (50,120] 1 end; (120,140] 0 ends -> cut after frames ending <= 120
    assert _frame_cut(ends, np.array([120, 140, 400], np.int64), 50) == 1
    # first packet empty -> nothing
    assert _frame_cut(ends, np.array([90, 400], np.int64), 50) == 0
    # no boundaries: keep everything
    assert _frame_cut(ends, np.zeros(0, np.int64), 50) == 3


def test_native_api_multitrack_parity(tmp_path, ref_oracle):
    """Default (native) path through the public API on a multi-track disc,
    exercising probe, packet boundaries and the tail-to-sync rule."""
    cfgs = [MlpSynthConfig(channel_assignment=17, substream_count=2,
                           bits_per_sample=24, sample_rate=96000,
                           n_frames=24, seed=s) for s in (1, 2)]
    tracks = [MlpTrackSpec(mlp_stream=synth_mlp_stream(c),
                           pcm_frames=c.total_pcm_frames,
                           sample_rate=96000, channel_assignment=17)
              for c in cfgs]
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [tracks])
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    title = DVDA(layout.path).open_titleset(1).open_title(1)
    for n in (1, 2):
        reader = title.open_track(n).open_reader(use_device=True)
        samples = reader.read_all()
        hdr = wave_header(reader.sample_rate, reader.channel_count,
                          reader.channel_mask, reader.bits_per_sample,
                          samples.shape[0])
        assert hdr + pack_samples_le(samples, reader.bits_per_sample) \
            == golden[f"track-01-{n:02d}.wav"], f"track {n}"


def test_native_multichunk_streams():
    """>512 restart chains exercises the chunked arena path (each chunk a
    separate async device dispatch sharing one compiled program); the
    1100-chain case spans 3 chunks."""
    for nfr, re_ in [(1100, 1), (180, 1)]:
        cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                             n_frames=nfr, restart_every=re_,
                             major_sync_every=re_, seed=3,
                             fir_across_restart=False)
        stream = synth_mlp_stream(cfg)
        params = stream_params(cfg)
        spec = MlpDecoder(params)
        spec.decode_bytes(stream)
        a = spec.take_frames()
        b = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
        assert b is not None and np.array_equal(a, b), (nfr, re_)


def test_read_all_packed_parity(tmp_path):
    """read_all_packed (device-packed WAV bytes) equals packing read_all."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         bits_per_sample=24, sample_rate=96000,
                         n_frames=24, seed=41)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames,
                        sample_rate=96000, channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])
    track = DVDA(layout.path).open_titleset(1).open_title(1).open_track(1)
    packed = track.open_reader(use_device=True).read_all_packed()
    ref_reader = track.open_reader(use_device=True)
    expect = pack_samples_le(ref_reader.read_all(), 24)
    assert packed == expect
    # 16-bit stream: device packs 2-byte samples (see _pack_bits)
    cfg16 = MlpSynthConfig(channel_assignment=1, bits_per_sample=16,
                           sample_rate=48000, n_frames=12, seed=42)
    spec16 = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg16),
                          pcm_frames=cfg16.total_pcm_frames,
                          sample_rate=48000, channel_assignment=1)
    layout16 = build_disc(str(tmp_path / "b" / "AUDIO_TS"), [[spec16]])
    tr = DVDA(layout16.path).open_titleset(1).open_title(1).open_track(1)
    a = tr.open_reader(use_device=True).read_all_packed()
    b = pack_samples_le(tr.open_reader(use_device=True).read_all(), 16)
    assert a == b


def test_multi_device_chunk_round_robin():
    """DVDA_MULTI_DEVICE=1 round-robins chain chunks over all local
    devices (8 virtual CPU devices under conftest) — bit-equal output."""
    import os

    import jax

    if len(jax.local_devices()) < 2:
        pytest.skip("needs multiple devices")
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=1100, restart_every=1, major_sync_every=1,
                         seed=3, fir_across_restart=False,
                         params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    single = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
    os.environ["DVDA_MULTI_DEVICE"] = "1"
    try:
        multi = decode_native(stream, np.zeros(0, np.int64), len(stream),
                              params)
    finally:
        del os.environ["DVDA_MULTI_DEVICE"]
    assert np.array_equal(single, multi)


def test_incremental_parse_matches_monolithic():
    """Stepped parse (mlp_parse_begin/step) commits exactly the arrays the
    one-shot parse produces, regardless of step granularity."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=60, seed=11)
    stream = synth_mlp_stream(cfg)
    mono = host.parse_mlp_stream(stream)
    assert mono is not None and mono.status == 0
    for step in (1, 7, 1000):
        inc = host.parse_mlp_stream_begin(stream)
        assert inc is not None
        while inc.step(step):
            pass
        v = inc.view()
        assert v.status == 0
        assert v.F == mono.F and v.T == mono.T
        assert np.array_equal(v.frame_len, mono.frame_len)
        assert np.array_equal(v.frame_end, mono.frame_end)
        assert np.array_equal(v.mat_coeff, mono.mat_coeff)
        assert np.array_equal(v.noise0, mono.noise0)
        assert np.array_equal(v.bypassed_packed, mono.bypassed_packed)
        for s in range(v.substream_count):
            for key in ("len", "restart", "shift", "quant", "rc_fir",
                        "rc_iir", "iir_init", "iir_reset", "residuals"):
                assert np.array_equal(v.sub[s][key], mono.sub[s][key]), \
                    (step, s, key)
        inc.close()
    mono.close()


def test_pipelined_packet_boundary_cut():
    """The pipelined path applies the zero-frame-packet cut: a boundary
    interval with no frame end truncates the decode exactly like the
    pull decoder (dvd-audio.c:766-775)."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=48, restart_every=2, major_sync_every=2,
                         seed=5, fir_across_restart=False,
                         params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    full = spec.take_frames()
    L0 = cfg.frames_per_mlp_frame

    # frame byte ends, to place a cut boundary mid-stream
    mono = host.parse_mlp_stream(stream)
    ends = np.asarray(mono.frame_end)
    mono.close()
    keep = 10
    # an interval (ends[keep-1], ends[keep-1]+1] contains no frame end
    bnd = np.array([ends[keep - 1], ends[keep - 1] + 1, len(stream)],
                   dtype=np.int64)
    out = decode_native(stream, bnd, int(ends[0]), params)
    assert out is not None
    assert out.shape[0] == keep * L0
    assert np.array_equal(out, full[: keep * L0])


def test_pipelined_nonuniform_bit_exact():
    """A stream whose block size changes mid-way decodes bit-exactly
    (handled by the sectioned pipelined driver since round 2)."""
    from dvda.testutil.mlp_synth import synth_two_section_stream

    stream, cfg = synth_two_section_stream()
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
    assert b is not None and np.array_equal(a, b)


def test_geometry_churn_falls_back_bit_exact():
    """More than 8 geometry changes abandons the sectioned driver (the
    gather path handles such streams) — output stays bit-exact."""
    from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream

    base = dict(channel_assignment=17, substream_count=2, sample_rate=48000,
                bits_per_sample=24, fir_across_restart=False,
                params_update_prob=0.0, n_frames=2, restart_every=1,
                major_sync_every=1)
    stream = b"".join(
        synth_mlp_stream(MlpSynthConfig(blocks_per_frame=2,
                                        block_size=16 if i % 2 else 32,
                                        seed=i, **base))
        for i in range(12))
    params = stream_params(MlpSynthConfig(**base))
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
    assert b is not None and np.array_equal(a, b)


def test_skip_values_tables_reconstruct_residuals():
    """skip-values parse (device-Huffman mode) emits per-block decode
    tables; re-decoding the raw bitstream with them must reproduce the
    normal parse's residual values and bypassed-LSB bits exactly."""
    from dvda.codecs.mlp.codebooks import peek_lut

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=24, seed=3)
    stream = synth_mlp_stream(cfg)
    full = host.parse_mlp_stream(stream)
    assert full is not None and full.status == 0
    inc = host.parse_mlp_stream_begin(stream, skip_values=True)
    assert inc is not None
    while inc.step(7):
        pass
    v = inc.view()
    assert v.status == 0 and v.skip_values
    assert v.F == full.F and v.T == full.T

    data = np.frombuffer(bytes(stream) + b"\0" * 8, np.uint8)

    def bits(pos, n):
        if n == 0:
            return 0
        w = int.from_bytes(bytes(data[pos >> 3 : (pos >> 3) + 8]), "big")
        return (w >> (64 - (pos & 7) - n)) & ((1 << n) - 1)

    luts = {k: peek_lut(k) for k in (1, 2, 3)}
    byp = np.zeros((full.T, 6), np.uint8)
    final = v.substream_count - 1
    for s in range(v.substream_count):
        sub, fsub = v.sub[s], full.sub[s]
        NB = sub["NB"]
        assert NB == fsub["NB"]
        n_ch = sub["codebook"].shape[1]
        seg = np.concatenate([[0], np.cumsum(sub["len"])]) * n_ch
        t = 0
        for b in range(NB):
            pos = int(sub["res_bitpos"][b])
            bs = int(sub["len"][b])
            slots = [m for m in range(6) if (int(sub["byp_mask"][b]) >> m) & 1]
            assert len(slots) == int(sub["nbyp"][b])
            for i in range(bs):
                for m in slots:
                    if s == final:
                        byp[t + i, m] = bits(pos, 1)
                    pos += 1
                for ci in range(n_ch):
                    cb = int(sub["codebook"][b, ci])
                    lb = int(sub["lsb_bits"][b, ci])
                    off = int(sub["res_offset"][b, ci])
                    q = int(sub["quant"][b, ci])
                    msb = 0
                    if cb:
                        vals, lens = luts[cb]
                        p9 = bits(pos, 9)
                        msb, n = int(vals[p9]), int(lens[p9])
                        assert n > 0
                        pos += n
                    lsb = bits(pos, lb)
                    pos += lb
                    vv = (((msb << lb) + lsb + off) << q) & 0xFFFFFFFF
                    vv = vv - (1 << 32) if vv >= (1 << 31) else vv
                    exp = int(fsub["residuals"][seg[b] + ci * bs + i])
                    assert vv == exp, (s, b, i, ci)
            t += bs
    packed = np.zeros(full.T, np.uint8)
    for m in range(6):
        packed |= (byp[:, m] << m).astype(np.uint8)
    assert np.array_equal(packed, np.asarray(full.bypassed_packed).view(np.uint8))
    inc.close()
    full.close()


def test_sectioned_pipeline_piecewise_uniform():
    """Piecewise-uniform streams decode through the sectioned pipelined
    driver (no gather-path fallback): block-size changes, restart-cadence
    changes and a partial tail chain each open a new uniform section."""
    from dvda.codecs.mlp import native_engine as ne
    from dvda.testutil.mlp_synth import MlpSynthConfig

    base = dict(channel_assignment=17, substream_count=2, sample_rate=48000,
                bits_per_sample=24, fir_across_restart=False,
                params_update_prob=0.0, checkdata=True)
    # section A: 16-sample blocks; B: 32-sample blocks; C: cadence change
    cfgs = [
        MlpSynthConfig(blocks_per_frame=2, block_size=16, seed=3,
                       n_frames=12, restart_every=2, major_sync_every=2,
                       **base),
        MlpSynthConfig(blocks_per_frame=2, block_size=32, seed=4,
                       n_frames=12, restart_every=2, major_sync_every=2,
                       **base),
        MlpSynthConfig(blocks_per_frame=2, block_size=16, seed=5,
                       n_frames=12, restart_every=4, major_sync_every=4,
                       **base),
    ]
    from dvda.testutil.mlp_synth import synth_mlp_stream as synth

    stream = b"".join(synth(c) for c in cfgs)
    params = stream_params(cfgs[0])
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
    assert b is not None and np.array_equal(a, b)
    assert ne._LAST_PIPELINE_INFO.get("sections", 0) >= 3

    # partial tail chain: n_frames not a multiple of the restart cadence
    cfg = MlpSynthConfig(blocks_per_frame=2, block_size=16, seed=6,
                         n_frames=10, restart_every=4, major_sync_every=4,
                         **base)
    stream = synth(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
    assert b is not None and np.array_equal(a, b)
    assert ne._LAST_PIPELINE_INFO.get("sections", 0) >= 2


def test_chunk_chains_invariance():
    """Decode is bit-identical for any chunk size (DecodeConfig.chunk_chains),
    including sizes that don't divide the chain count, and the parser's
    param_update flag routes parameter-constant chains to per-chain rows."""
    from dvda.config import DecodeConfig

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=300, restart_every=2, major_sync_every=2,
                         seed=11, fir_across_restart=False,
                         params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    base = decode_native(stream, np.zeros(0, np.int64), len(stream), params)
    assert base is not None
    for chains in (7, 32, 1024):
        got = decode_native(stream, np.zeros(0, np.int64), len(stream),
                            params, config=DecodeConfig(chunk_chains=chains))
        assert got is not None and np.array_equal(base, got), chains
    # mid-stream parameter updates must fall off the per-chain rows but
    # still decode exactly (per-block parameter path)
    cfg2 = MlpSynthConfig(channel_assignment=17, substream_count=2,
                          n_frames=64, restart_every=4, major_sync_every=4,
                          seed=12, fir_across_restart=False,
                          params_update_prob=0.4)
    stream2 = synth_mlp_stream(cfg2)
    params2 = stream_params(cfg2)
    spec = MlpDecoder(params2)
    spec.decode_bytes(stream2)
    a = spec.take_frames()
    b = decode_native(stream2, np.zeros(0, np.int64), len(stream2), params2)
    assert b is not None and np.array_equal(a, b)


def test_parser_block_flags():
    """param_update marks exactly the blocks that re-read decoding params;
    fir_any equals rc_fir.any per block (the engine's coupling test)."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=48, restart_every=4, major_sync_every=4,
                         seed=5, params_update_prob=0.3)
    stream = synth_mlp_stream(cfg)
    parse = host.parse_mlp_stream(stream)
    assert parse is not None and parse.status == 0
    try:
        for s in range(parse.substream_count):
            sub = parse.sub[s]
            nb = sub["len"].shape[0]
            assert sub["param_update"].shape == (nb,)
            fir_ref = sub["rc_fir"].reshape(nb, -1).any(axis=1)
            assert np.array_equal(sub["fir_any"] != 0, fir_ref)
            # restarts always carry a parameter read
            assert (sub["param_update"][sub["restart"]] == 1).all()
            # iir resets only happen in blocks that re-read parameters
            blk_irst = sub["iir_reset"].any(axis=1)
            assert not (blk_irst & (sub["param_update"] == 0)).any()
    finally:
        parse.close()


def _parse_arrays_equal(a, b):
    """Every array of two NativeParse results is identical."""
    assert a.status == 0 and b.status == 0
    assert (a.F, a.T, a.substream_count, a.mmc, a.assignment) == \
        (b.F, b.T, b.substream_count, b.mmc, b.assignment)
    for name in ("frame_len", "frame_end", "out_shift", "mat_active",
                 "mat_out", "mat_quant", "mat_coeff", "mat_noise",
                 "noise0", "noise1", "frame_seed", "frame_nshift",
                 "bypassed_packed"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for s in range(a.substream_count):
        for k in a.sub[s]:
            x, y = a.sub[s][k], b.sub[s][k]
            if isinstance(x, np.ndarray):
                assert np.array_equal(x, y), (s, k)
            else:
                assert x == y, (s, k)


MT_STREAMS = {
    "uniform": dict(channel_assignment=17, substream_count=2, n_frames=600,
                    seed=7),
    "param_churn": dict(channel_assignment=17, substream_count=2,
                        n_frames=600, seed=9, params_update_prob=0.3),
    "stereo": dict(channel_assignment=1, substream_count=1, n_frames=600,
                   seed=11),
    "fir_coupled": dict(channel_assignment=17, substream_count=2,
                        n_frames=600, seed=15, fir_across_restart=True),
}


@pytest.mark.parametrize("name", sorted(MT_STREAMS))
def test_mt_parse_bit_identical(name):
    """Threaded section parse == sequential parse, array for array."""
    cfg = MlpSynthConfig(major_sync_every=8, restart_every=8,
                         blocks_per_frame=2, block_size=40,
                         **MT_STREAMS[name])
    stream = synth_mlp_stream(cfg)
    assert len(stream) > 64 << 10  # below this the MT path won't engage
    seq = host.parse_mlp_stream(stream)
    inc = host.parse_mlp_stream_begin(stream, threads=4)
    assert inc.step(0) is False  # step(0) finishes the walk
    mt = inc.view()
    _parse_arrays_equal(seq, mt)
    seq.close()
    inc.close()


def test_mt_parse_corrupt_local_repair():
    """One corrupt frame costs at most a local ≤2-section sequential
    repair — never the whole-stream redo — and the result
    stays bit-identical to the sequential parse.  A sweep of corruption
    positions across the stream covers both cases: mid-section drops
    (no repair at all — the section's own parse already equals the
    sequential one) and section-ENTRY drops (the ≤2-section repair)."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=600, seed=7, major_sync_every=4,
                         restart_every=4, blocks_per_frame=2, block_size=40)
    base = synth_mlp_stream(cfg)
    assert len(base) > 64 << 10
    # frame starts (framing is length-delimited and corruption below never
    # touches the first two header bytes)
    starts, off = [], 0
    while off + 4 <= len(base):
        total = (((base[off] & 0x0F) << 8) | base[off + 1]) * 2
        if total < 4 or off + total > len(base):
            break
        starts.append(off)
        off += total
    assert len(starts) >= 500
    total_repairs = 0
    for fi in range(3, len(starts) - 3, 13):  # ~45 positions, all sections
        data = bytearray(base)
        data[starts[fi] + 40] ^= 0x5A  # inside the frame body: CRC drop
        data = bytes(data)
        seq = host.parse_mlp_stream(data)
        inc = host.parse_mlp_stream_begin(data, threads=4)
        inc.step(0)
        repairs, full_redo = inc.mt_stats
        assert full_redo == 0, fi  # 1 corrupt frame never redoes the stream
        assert repairs <= 1, fi
        total_repairs += repairs
        if seq.status == 0:
            _parse_arrays_equal(seq, inc.view())
        else:
            assert inc.view().status == seq.status, fi
        seq.close()
        inc.close()
    # the sweep must have hit at least one section-entry frame, or the
    # repair path went untested
    assert total_repairs >= 1


def test_mt_parse_corrupt_redo_bit_identical():
    """Corrupt frames (mid-section drops and entry-frame repairs) leave
    the threaded parse bit-identical to the sequential one."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=600, seed=7, major_sync_every=8,
                         restart_every=8, blocks_per_frame=2, block_size=40)
    stream = bytearray(synth_mlp_stream(cfg))
    stream[len(stream) // 2] ^= 0xFF
    stream[len(stream) // 3] ^= 0x55
    stream = bytes(stream)
    seq = host.parse_mlp_stream(stream)
    inc = host.parse_mlp_stream_begin(stream, threads=4)
    inc.step(0)
    _parse_arrays_equal(seq, inc.view())
    seq.close()
    inc.close()


def test_mt_parse_skip_values_bit_identical():
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=600, seed=7, major_sync_every=8,
                         restart_every=8, blocks_per_frame=2, block_size=40)
    stream = synth_mlp_stream(cfg)
    a = host.parse_mlp_stream_begin(stream, skip_values=True)
    a.step(0)
    b = host.parse_mlp_stream_begin(stream, skip_values=True, threads=4)
    b.step(0)
    _parse_arrays_equal(a.view(), b.view())
    a.close()
    b.close()


def test_mt_parse_incremental_stepping():
    """step(n) merges one section at a time; views grow monotonically."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=600, seed=7, major_sync_every=8,
                         restart_every=8, blocks_per_frame=2, block_size=40)
    stream = synth_mlp_stream(cfg)
    seq = host.parse_mlp_stream(stream)
    inc = host.parse_mlp_stream_begin(stream, threads=4)
    sizes = []
    while inc.step(64):
        sizes.append(inc.view().F)
    mt = inc.view()
    assert len(sizes) >= 2, "expected multiple merge steps"
    assert sizes == sorted(sizes)
    _parse_arrays_equal(seq, mt)
    seq.close()
    inc.close()


def test_decode_native_parse_threads_bit_exact():
    from dvda.config import DecodeConfig

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=600, seed=7, major_sync_every=8,
                         restart_every=8, blocks_per_frame=2, block_size=40)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    bnd = np.zeros(0, np.int64)
    a = decode_native(stream, bnd, len(stream), params,
                      config=DecodeConfig(parse_threads=1))
    b = decode_native(stream, bnd, len(stream), params,
                      config=DecodeConfig(parse_threads=4))
    assert a is not None and b is not None
    assert np.array_equal(a, b)


def _chunk_inputs(stream, skip_values=False, sub_every=0):
    """Parse ``stream`` and derive the uniform-chunk dispatch inputs
    (parse, subs_info, period, L0) the way the production path does."""
    if skip_values:
        inc = host.parse_mlp_stream_begin(stream, skip_values=True,
                                          sub_every=sub_every)
        inc.step(0)
        parse = inc.view()
        # the view is borrowed (its close() is a no-op): route close()
        # to the owning handle so callers' parse.close() actually frees
        parse.close = inc.close
    else:
        parse = host.parse_mlp_stream(stream)
    assert parse is not None and parse.status == 0
    F = _frame_cut(parse.frame_end, np.zeros(0, np.int64), len(stream))
    L0 = int(parse.frame_len[0])
    subs_info = []
    for s in range(parse.substream_count):
        sub = parse.sub[s]
        nb_keep = int(sub["fr_nblocks"][:F].sum())
        S0 = int(sub["len"][0])
        restarts = np.nonzero(sub["restart"][:nb_keep])[0]
        coupled = sub["fir_any"][restarts] != 0
        starts = [0] + [int(r) for i, r in enumerate(restarts)
                        if r != 0 and not coupled[i]]
        NB0 = int(np.diff(starts + [nb_keep])[0])
        subs_info.append((sub, 0, S0, NB0, 0))
    period = subs_info[0][2] * subs_info[0][3]
    return parse, subs_info, period, L0


@pytest.mark.parametrize("devhuff", [False, True])
def test_native_pack_matches_numpy_pack(devhuff, monkeypatch):
    """mp_pack (C++ arena assembly) produces byte-identical arenas and an
    identical static spec to the numpy _ArenaBuilder path, in both
    standard and device-Huffman modes."""
    from dvda.codecs.mlp import native_engine as ne

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=40, restart_every=4, major_sync_every=4,
                         blocks_per_frame=2, block_size=24, seed=9,
                         fir_across_restart=False, params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    parse, subs_info, period, L0 = _chunk_inputs(
        stream, skip_values=devhuff, sub_every=8 if devhuff else 0)
    words_all = ne._SharedWords(stream) if devhuff else None
    nc = (subs_info[0][0]["NB"] // subs_info[0][3]) - 1  # partial chunk
    CHUNK = 16

    captured = []
    monkeypatch.setattr(ne, "_uniform_arena_pipeline",
                        lambda a4, a2, a1, spec, words=None:
                        (a4, a2, a1, spec))
    for native in (True, False):
        captured.append(ne._dispatch_uniform_chunk(
            parse, subs_info, 0, nc, CHUNK, period, L0, 6,
            pack_bits=24, words_all=words_all, native_pack=native))
    (n4, n2, n1, nspec), (p4, p2, p1, pspec) = captured
    assert nspec == pspec
    assert np.array_equal(n4, p4)
    assert np.array_equal(n2, p2)
    assert np.array_equal(n1, p1)
    parse.close()


def test_native_filter_unroll_bit_equal():
    """DecodeConfig.filter_unroll (DVDA_FILTER_UNROLL) trades compile
    time for chunk throughput; output must stay bit-identical."""
    from dvda.config import DecodeConfig

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=24, seed=5)
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                      config=DecodeConfig(filter_unroll=4))
    assert b is not None and np.array_equal(a, b)


def test_mp_pack_rejects_undersized_arena():
    """mp_pack must bounds-check DESTINATION writes: an arena smaller
    than the instruction list assumes is a loud error, never heap
    corruption (review r3)."""
    from dvda import host

    cfg = MlpSynthConfig(channel_assignment=1, n_frames=4, seed=3)
    stream = synth_mlp_stream(cfg)
    inc = host.parse_mlp_stream_begin(stream)
    while inc.step(5):
        pass
    view = inc.view()
    # CHAIN op: 1 block row of rc_fir (inner 8*... elements) at off 0
    inst = np.zeros((1, 12), np.int64)
    inst[0] = [0, 0, 0, 0, 1, 1, 16, 0, 0, 0, 4, 0]  # op=CHAIN width=4
    ok4 = np.zeros(16, np.int32)
    a2 = np.zeros(0, np.int16)
    a1 = np.zeros(0, np.int8)
    view.pack(inst, ok4, a2, a1)  # exactly fits
    small = np.zeros(15, np.int32)
    with pytest.raises(RuntimeError):
        view.pack(inst, small, a2, a1)  # one element short
    inst[0, 11] = 1  # off pushes past the end
    with pytest.raises(RuntimeError):
        view.pack(inst, ok4, a2, a1)
    inst[0, 11] = 0
    inst[0, 10] = 3  # invalid width
    with pytest.raises(RuntimeError):
        view.pack(inst, ok4, a2, a1)
    inc.close()


@pytest.mark.parametrize("devhuff", [False, True])
def test_narrow_d2h_parity_quiet_and_loud(devhuff):
    """narrow_d2h (config.py) is lossless across all three tiers: a QUIET
    stream rides the 12-bit channel-pair buffer, a MID stream (beyond 12
    bits but within int16, via out_shift_range) settles on the 16-bit
    tier, and a LOUD stream — samples beyond int16 — trips the per-chunk
    wide fallback in _finish_uniform.  All must be byte-identical to the
    narrow_d2h=False decode and to the sequential spec."""
    from dataclasses import replace

    from dvda.config import DecodeConfig

    base = DecodeConfig.from_env()
    seen = set()
    for shifts, kind in (((0, 1), "quiet"), ((5, 6), "mid"),
                         ((7, 8), "loud")):
        cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                             n_frames=24, seed=11, out_shift_range=shifts)
        stream = synth_mlp_stream(cfg)
        params = stream_params(cfg)
        spec = MlpDecoder(params)
        spec.decode_bytes(stream)
        ref = spec.take_frames()
        amax = np.abs(ref).max()
        got = ("loud" if amax > 32767 else
               "mid" if amax > 2047 else "quiet")
        assert got == kind, (kind, amax)  # the knob must hit the range
        seen.add(kind)
        on = decode_native(stream, np.zeros(0, np.int64), len(stream),
                           params, want_packed=True,
                           config=replace(base, narrow_d2h=True,
                                          device_huffman=devhuff))
        off = decode_native(stream, np.zeros(0, np.int64), len(stream),
                            params, want_packed=True,
                            config=replace(base, narrow_d2h=False,
                                           device_huffman=devhuff))
        assert on is not None and off is not None
        assert bytes(on) == bytes(off)
        assert bytes(on) == bytes(pack_samples_le(ref, 24))
    assert seen == {"quiet", "mid", "loud"}


def test_host_widen12_matches_numpy():
    """mp_widen12 (the 12-bit-tier drain widen) is byte-exact vs the
    numpy formula, including sign extension at the 12-bit boundary."""
    from dvda import host

    if not host.available():
        pytest.skip("native host library unavailable")
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 64, 1001):
        vals = rng.integers(-2048, 2048, size=(n, 2), dtype=np.int32)
        vals[: min(n, 4)] = [[-2048, 2047], [-1, 0], [2047, -2048],
                             [0, -1]][: min(n, 4)]
        c0, c1 = vals[:, 0] & 0xFFF, vals[:, 1] & 0xFFF
        triples = np.empty((n, 3), np.uint8)
        triples[:, 0] = c0 & 0xFF
        triples[:, 1] = ((c0 >> 8) & 0xF) | ((c1 & 0xF) << 4)
        triples[:, 2] = (c1 >> 4) & 0xFF
        dst = np.empty(6 * n, np.uint8)
        assert host.widen12(triples, dst)
        want = np.empty((n, 2, 3), np.uint8)
        for j in range(2):
            want[:, j, 0] = vals[:, j] & 0xFF
            want[:, j, 1] = (vals[:, j] >> 8) & 0xFF
            want[:, j, 2] = (vals[:, j] >> 16) & 0xFF
        assert np.array_equal(dst.reshape(n, 2, 3), want)


def test_narrow_poll_semantics():
    """_narrow_poll checks only the FIRST narrow chunk (adaptive tier
    settle; all later chunks drain through the batched fetch): a landed
    fits-chunk is kept as a host copy with its redo closure dropped and
    the tier stays; a 12-bit chunk that fits only int16 (flag bit 1)
    reruns through the 16-bit program and moves the track to tier 16; a
    full overflow reruns wide and turns narrow off; an unready chunk is
    left alone by nonblocking polls; once checked, later polls no-op."""
    from dvda.codecs.mlp.native_engine import _narrow_poll

    class FakeDev:
        """Array-convertible stand-in for a narrow+flag device buffer."""

        def __init__(self, flag, ready=True):
            self.arr = np.zeros((9, 4), np.uint8)
            self.arr[-1, -1] = flag
            self.ready = ready

        def is_ready(self):
            return self.ready

        def __array__(self, dtype=None, copy=None):
            return self.arr

    def mk(flag, tier, ready=True):
        calls = []
        redo = lambda retier=0: (calls.append(retier)
                                 or np.ones((8, 12), np.uint8))
        return (FakeDev(flag, ready), redo, tier), calls

    # fits case: host copy kept, redo dropped, tier stays, one check
    fit_dev, fit_calls = mk(3, 12)
    other_dev, other_calls = mk(0, 12)
    pending = [(fit_dev, 8), (other_dev, 8)]
    state = {"narrow": 12, "checked": False}
    _narrow_poll(pending, state)
    assert state["checked"] and state["narrow"] == 12
    assert pending[0][0][1] is None and not fit_calls
    _narrow_poll(pending, state)  # later polls never touch chunk 2
    assert not other_calls and pending[1][0][1] is not None

    # 12-bit overflow that fits int16: redo(16), tier moves to 16
    mid_dev, mid_calls = mk(2, 12)
    pending = [(mid_dev, 8)]
    state = {"narrow": 12, "checked": False}
    _narrow_poll(pending, state)
    assert mid_calls == [16] and state["narrow"] == 16
    assert isinstance(pending[0][0], tuple) and pending[0][0][2] == 16

    # full overflow: redo() wide once, plain array, narrow off
    ovf_dev, ovf_calls = mk(0, 16)
    pending = [(ovf_dev, 8)]
    state = {"narrow": 16, "checked": False}
    _narrow_poll(pending, state)
    assert ovf_calls == [0] and isinstance(pending[0][0], np.ndarray)
    assert not state["narrow"] and state["checked"]

    # unready chunk: nonblocking poll leaves it; blocking poll consumes it
    late_dev, late_calls = mk(1, 16, ready=False)
    pending = [(late_dev, 8)]
    state = {"narrow": 16, "checked": False}
    _narrow_poll(pending, state)
    assert not state["checked"] and pending[0][0][1] is not None
    _narrow_poll(pending, state, block=True)
    assert state["checked"] and pending[0][0][1] is None and not late_calls


def test_bail_reason_surfaced_and_logged(caplog):
    """A native-parser bail names its reason (mp_bail_reason) and
    decode_native logs one WARNING naming it before falling back to the
    pure-Python decoder.  Bail used here: frame 0's body
    is corrupted so its CRC drops the frame (after the major sync set
    have_sync), and frame 1 then starts without a restart header."""
    import logging

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=32, seed=7, major_sync_every=8,
                         restart_every=8, blocks_per_frame=2, block_size=40)
    stream = bytearray(synth_mlp_stream(cfg))
    stream[40] ^= 0x5A  # in frame 0's substream data: CRC mismatch -> drop
    stream = bytes(stream)
    parse = host.parse_mlp_stream(stream)
    assert parse.status != 0
    assert parse.bail_reason == 2  # no restart header at stream start
    assert "restart" in host.bail_reason_text(parse.bail_reason)

    with caplog.at_level(logging.WARNING, logger="dvda"):
        out = decode_native(stream, np.zeros(0, np.int64), len(stream),
                            stream_params(cfg))
    assert out is None  # callers fall back to the Python engines
    msgs = [r.getMessage() for r in caplog.records
            if "native MLP parse bailed" in r.getMessage()]
    assert msgs and "restart" in msgs[0]


def test_host_widen24_matches_numpy():
    """mp_widen24 (the narrow-d2h drain's int16 -> 24-bit WAV widen) is
    byte-exact vs the numpy formula, including the scalar tail for
    n % 4 != 0 and sign extension of negative highs."""
    from dvda import host

    if not host.available():
        pytest.skip("native host library unavailable")
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 4, 5, 7, 64, 1001):
        pairs = rng.integers(0, 256, size=(n, 2), dtype=np.uint8)
        pairs[: min(n, 4), 1] = 0xFF  # force negative sign extensions
        dst = np.empty(3 * n, np.uint8)
        assert host.widen24(pairs, dst)
        want = np.empty((n, 3), np.uint8)
        want[:, :2] = pairs
        want[:, 2] = (pairs[:, 1].view(np.int8) >> 7).view(np.uint8)
        assert np.array_equal(dst.reshape(n, 3), want)


@pytest.mark.parametrize("devhuff", [False, True])
def test_drain_thread_differential(devhuff):
    """The background drain thread (round 5, config.drain_thread) is
    byte-identical to the end-of-stream batched drain across many small
    chunks, all three narrow-tier contents (quiet rides 12-bit, mid
    settles to 16-bit, loud redispatches wide — exercising the drain
    thread's settle + redo paths), and a two-section piecewise-uniform
    stream."""
    from dataclasses import replace

    from dvda.config import DecodeConfig

    base = replace(DecodeConfig.from_env(), chunk_chains=2,
                   device_huffman=devhuff)
    sec = dict(channel_assignment=17, substream_count=2, sample_rate=48000,
               bits_per_sample=24, fir_across_restart=False,
               params_update_prob=0.0, checkdata=True)
    streams = {}
    for shifts, kind in (((0, 1), "quiet"), ((5, 6), "mid"),
                         ((7, 8), "loud")):
        cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                             n_frames=24, seed=11, out_shift_range=shifts)
        streams[kind] = (synth_mlp_stream(cfg), stream_params(cfg))
    two = [MlpSynthConfig(blocks_per_frame=2, block_size=16, seed=3,
                          n_frames=12, restart_every=2, major_sync_every=2,
                          **sec),
           MlpSynthConfig(blocks_per_frame=2, block_size=32, seed=4,
                          n_frames=12, restart_every=2, major_sync_every=2,
                          **sec)]
    streams["two-section"] = (b"".join(synth_mlp_stream(c) for c in two),
                              stream_params(two[0]))
    for kind, (stream, params) in streams.items():
        on = decode_native(stream, np.zeros(0, np.int64), len(stream),
                           params, want_packed=True,
                           config=replace(base, drain_thread=True))
        off = decode_native(stream, np.zeros(0, np.int64), len(stream),
                            params, want_packed=True,
                            config=replace(base, drain_thread=False))
        assert on is not None and off is not None, kind
        assert bytes(on) == bytes(off), kind


def test_mt_parse_multi_corrupt_local_repairs():
    """k corrupt frames in DISTINCT sections each cost a local repair
    (round 5) — the whole-stream sequential redo never
    fires — and every result stays bit-identical to the sequential
    parse.  The sweep plants 2-3 corruptions at varying strides so some
    combinations hit several section-entry frames (repairs >= 2,
    asserted in aggregate) including CONSECUTIVE damaged sections."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=600, seed=7, major_sync_every=4,
                         restart_every=4, blocks_per_frame=2, block_size=40)
    base = synth_mlp_stream(cfg)
    starts, off = [], 0
    while off + 4 <= len(base):
        total = (((base[off] & 0x0F) << 8) | base[off + 1]) * 2
        if total < 4 or off + total > len(base):
            break
        starts.append(off)
        off += total
    assert len(starts) >= 500

    def parse_both(picks):
        data = bytearray(base)
        for fi in picks:
            data[starts[fi] + 40] ^= 0x5A
        data = bytes(data)
        seq = host.parse_mlp_stream(data)
        inc = host.parse_mlp_stream_begin(data, threads=4)
        inc.step(0)
        repairs, full_redo = inc.mt_stats
        if seq.status == 0:
            _parse_arrays_equal(seq, inc.view())
        else:
            assert inc.view().status == seq.status, picks
        seq.close()
        inc.close()
        return repairs, full_redo

    # discover section-ENTRY frames (single corruption => repairs == 1)
    # near the byte-balanced cut points, then damage several at once
    entries = []
    for k in (1, 2, 3):
        target = len(base) * k // 4
        fi0 = min(range(len(starts)), key=lambda i: abs(starts[i] - target))
        for fi in range(max(1, fi0 - 25), min(len(starts) - 1, fi0 + 25)):
            repairs, full_redo = parse_both([fi])
            assert full_redo == 0, fi
            if repairs == 1:
                entries.append(fi)
                break
    assert len(entries) >= 2, "no section entries found near the cuts"
    for picks in ([entries[0], entries[1]], entries):
        repairs, full_redo = parse_both(picks)
        assert full_redo == 0, picks  # round 4 full-redid on the 2nd wound
        assert repairs == len(picks), picks  # one LOCAL repair per wound

    # adjacent-frame corruption burst: damages consecutive sections'
    # entries (the round-4 code full-redid on the second wound)
    for fi in range(3, len(starts) - 40, 37):
        data = bytearray(base)
        for k in range(0, 40, 4):  # 10 corrupt frames in a tight burst
            data[starts[fi + k] + 40] ^= 0x5A
        data = bytes(data)
        seq = host.parse_mlp_stream(data)
        inc = host.parse_mlp_stream_begin(data, threads=4)
        inc.step(0)
        _repairs, full_redo = inc.mt_stats
        assert full_redo == 0, fi
        if seq.status == 0:
            _parse_arrays_equal(seq, inc.view())
        else:
            assert inc.view().status == seq.status, fi
        seq.close()
        inc.close()


def test_paired_parse_differential_subprocess():
    """DVDA_HOST_PAIRED=0 (sequential two-substream decode) produces the
    same parse as the round-5 paired walk — including on a corrupt
    stream, where the paired path retries the damaged frame sequentially
    from a state snapshot.  env is read once per process, so the
    sequential side runs in a child."""
    import json
    import os
    import subprocess
    import sys

    code = r"""
import json, sys
import numpy as np
sys.path.insert(0, %r)
from dvda import host
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream

cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                     n_frames=48, seed=21, params_update_prob=0.2)
base = bytearray(synth_mlp_stream(cfg))
base[len(base) // 2] ^= 0x5A  # corrupt mid-stream: frame-drop + retry path
p = host.parse_mlp_stream(bytes(base))
digest = {
    "F": int(p.F),
    "frame_len": int(p.frame_len.sum()),
    "noise": int(np.int64(p.noise0[:]).sum() + np.int64(p.noise1[:]).sum()),
    "res": [int(np.int64(p.sub[s]["residuals"]).sum()) for s in (0, 1)],
    "shift": [int(p.sub[s]["shift"].sum()) for s in (0, 1)],
}
p.close()
print(json.dumps(digest))
""" % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),)
    outs = []
    for paired in ("1", "0"):
        env = dict(os.environ, DVDA_HOST_PAIRED=paired)
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, timeout=300, check=True)
        outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert outs[0]["F"] > 0


def test_frame_pair_skip_parse_engages_and_aborts():
    """The four-chain frame-pair skip walk (round 5) must actually ENGAGE
    on pairable streams (pairs > 0 — guards the gate condition silently
    turning every parse serial) and must fall back to the serial path on
    mid-frame parameter updates, still finishing clean.  Output equality
    with the pair-disabled driver is pinned separately by the native-vs-
    spec and devhuff tests, which run with the pair enabled by default."""
    from dvda.config import DecodeConfig

    split = DecodeConfig().resolved_huffman_split()

    # params only at restart frame-starts: nearly every frame pairs
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=200, restart_every=8, major_sync_every=8,
                         seed=21, fir_across_restart=False,
                         params_update_prob=0.0)
    inc = host.parse_mlp_stream_begin(synth_mlp_stream(cfg),
                                      skip_values=True, threads=1,
                                      sub_every=split)
    inc.step(0)
    assert inc.view().status == 0
    pairs, falls = inc.pair_stats
    inc.close()
    assert pairs >= 80, (pairs, falls)  # ~100 pairs for 200 frames

    # heavy mid-frame parameter updates: pair aborts happen, parse stays
    # clean, and whatever still pairs is counted
    cfg2 = MlpSynthConfig(channel_assignment=17, substream_count=2,
                          n_frames=200, restart_every=4, major_sync_every=4,
                          seed=22, fir_across_restart=False,
                          params_update_prob=0.5)
    inc2 = host.parse_mlp_stream_begin(synth_mlp_stream(cfg2),
                                       skip_values=True, threads=1,
                                       sub_every=split)
    inc2.step(0)
    assert inc2.view().status == 0
    pairs2, falls2 = inc2.pair_stats
    inc2.close()
    assert falls2 >= 5, (pairs2, falls2)  # abort path exercised


def test_corrupt_frame_invalidates_emit_cache():
    """Review r5 (CONFIRMED): a frame can drop MID-parameter-read —
    read_decoding_parameters throws after partially mutating ch[]/quant,
    and the reference's drop semantics KEEP the partial mutation.  The
    prep-row emit cache must not survive such a drop, or the next
    no-params block memcpys rows derived from the pre-mutation state
    (observed as shape/value divergence from the spec decoder at corrupt
    bytes 61/466 of this exact stream before the rollback_frame
    invalidation)."""
    from dvda.testutil.synth import BPS_CODE, RATE_CODE

    cfg = MlpSynthConfig(channel_assignment=1, substream_count=1,
                         n_frames=16, seed=5, major_sync_every=8,
                         restart_every=8, blocks_per_frame=4,
                         params_update_prob=0.5)
    stream = bytes(synth_mlp_stream(cfg))
    params = StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[96000], 0xF, 1)
    checked = 0
    for pos in (61, 466, 100, 200, 300, 700, 900, 1200, 1500, 2000):
        s = bytearray(stream)
        s[pos] ^= 0x5A
        try:
            spec = MlpDecoder(params)
            spec.decode_bytes(bytes(s))
            a = spec.take_frames()
        except Exception:
            continue  # the spec decoder itself rejects this corruption
        b = decode_native(bytes(s), np.zeros(0, np.int64), len(s), params)
        if b is None:
            continue  # native bailed to the spec fallback — also exact
        checked += 1
        assert a.shape == b.shape and np.array_equal(a, b), pos
    assert checked >= 5  # the sweep must actually exercise the cache
