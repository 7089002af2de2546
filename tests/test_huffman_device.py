"""On-device Huffman residual decode (ops/huffman_decode.py) tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from dvda import host
from dvda.codecs.mlp.codebooks import peek_lut
from dvda.ops.huffman_decode import (
    decode_residuals_device,
    decode_residuals_numpy,
)
from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")


def _luts():
    vals = np.zeros(2048, np.int32)
    lens = np.zeros(2048, np.int32)
    for k in (1, 2, 3):
        v, l = peek_lut(k)
        vals[k * 512 : (k + 1) * 512] = v
        lens[k * 512 : (k + 1) * 512] = l
    return vals, lens


def _stream_words(stream: bytes) -> np.ndarray:
    pad = (-len(stream)) % 4 + 8
    return np.frombuffer(bytes(stream) + b"\0" * pad, dtype=">u4").astype(np.uint32)


@pytest.mark.parametrize("assign,nsub", [(1, 1), (17, 2)])
@pytest.mark.parametrize("split", [0, 8, 7])
def test_kernel_matches_numpy_and_host(assign, nsub, split):
    cfg = MlpSynthConfig(channel_assignment=assign, substream_count=nsub,
                         n_frames=16, seed=4, restart_every=2,
                         major_sync_every=2, fir_across_restart=False,
                         params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    full = host.parse_mlp_stream(stream)
    assert full is not None and full.status == 0
    inc = host.parse_mlp_stream_begin(stream, skip_values=True,
                                      sub_every=split)
    while inc.step(5):
        pass
    v = inc.view()
    assert v.status == 0
    vals, lens = _luts()
    words = _stream_words(stream)
    for s in range(v.substream_count):
        sub = v.sub[s]
        NB = sub["NB"]
        n_ch = sub["codebook"].shape[1]
        S0 = int(sub["len"][0])
        assert (sub["len"] == S0).all()
        res_np, byp_np = decode_residuals_numpy(stream, sub, vals, lens)

        bp = sub["res_bitpos"].astype(np.int32)
        if split:
            nsp = -(-S0 // split)
            rel = sub["sub_bitpos"].reshape(NB, nsp)
            bp = bp[:, None] + rel
            k = min(split, S0)
        else:
            bp = bp[:, None]
            k = S0
        from dvda.codecs.mlp.native_engine import _window_rows

        NW = _window_rows(sub["sub_span_max"])
        wpad = np.zeros(-len(words) % NW + NW, np.uint32)
        J = n_ch + (1 if sub["nbyp"].any() else 0)  # burst-slot schedule
        res_d, byp_d = decode_residuals_device(
            jnp.asarray(np.concatenate([words, wpad])),
            jnp.asarray(bp),
            jnp.asarray(sub["codebook"].astype(np.int32)),
            jnp.asarray(sub["lsb_bits"].astype(np.int32)),
            jnp.asarray(sub["res_offset"].astype(np.int32)),
            jnp.asarray(sub["quant"].astype(np.int32)),
            jnp.asarray(sub["nbyp"].astype(np.int32)),
            S0, J, k, NW)
        res_d = np.asarray(res_d).transpose(1, 0, 2)  # [C,NB,S0]→[NB,C,S0]
        byp_d = np.asarray(byp_d)                     # [NB, S0] burst field
        assert np.array_equal(res_d, res_np), s

        # kernel byp is the packed burst field (bit 5-k = k-th bypass
        # symbol); map symbol k to slot m via byp_mask
        byp_slots = np.zeros((NB, S0, 6), np.int32)
        for b in range(NB):
            slot = 0
            for m in range(6):
                if (int(sub["byp_mask"][b]) >> m) & 1:
                    byp_slots[b, :, m] = (byp_d[b] >> (5 - slot)) & 1
                    slot += 1
        assert np.array_equal(byp_slots, byp_np), s

        # and the host's value-mode residuals agree (ragged → [NB, ch, S0])
        fsub = full.sub[s]
        ragged = fsub["residuals"].reshape(NB, n_ch, S0)
        assert np.array_equal(res_np, ragged), s
    inc.close()
    full.close()


def test_device_huffman_pipeline_bit_exact():
    """Full decode with device_huffman: the uniform pipeline re-decodes
    residuals + bypassed LSBs on device and must match the spec decoder
    bit-exactly (incl. rematrix bypass add)."""
    from dvda.codecs.mlp.native_engine import decode_native
    from dvda.codecs.mlp.spec import MlpDecoder
    from dvda.codecs.params import StreamParameters
    from dvda.config import DecodeConfig
    from dvda.testutil.synth import BPS_CODE, RATE_CODE

    for assign, nsub, nfr in [(17, 2, 48), (1, 1, 32), (17, 2, 1100)]:
        cfg = MlpSynthConfig(channel_assignment=assign,
                             substream_count=nsub, n_frames=nfr,
                             restart_every=2, major_sync_every=2, seed=6,
                             fir_across_restart=False,
                             params_update_prob=0.0)
        stream = synth_mlp_stream(cfg)
        from dvda.codecs.params import StreamParameters as SP

        params = SP(BPS_CODE[cfg.bits_per_sample], 0xF,
                    RATE_CODE[cfg.sample_rate], 0xF, assign)
        spec = MlpDecoder(params)
        spec.decode_bytes(stream)
        a = spec.take_frames()
        b = decode_native(stream, np.zeros(0, np.int64), len(stream),
                          params, config=DecodeConfig(device_huffman=True))
        assert b is not None and np.array_equal(a, b), (assign, nsub, nfr)


@pytest.mark.parametrize("choices", [(0,), (0, 2)])
def test_device_huffman_fixed_rate_blocks_bit_exact(choices):
    """Streams whose channels use codebook 0 (no Huffman codes) hit the
    parser's O(1) fixed-rate block path (mlp_parse.cc skip_residuals:
    every sample costs a constant bit count, sub-lane offsets are
    affine); mixed (0, 2) streams exercise the constant-gap folding
    around the remaining coded channels.  Both must stay bit-exact vs
    the spec decoder through the device-Huffman pipeline."""
    from dvda.codecs.mlp.native_engine import decode_native
    from dvda.codecs.mlp.spec import MlpDecoder
    from dvda.config import DecodeConfig
    from dvda.testutil.synth import BPS_CODE, RATE_CODE
    from dvda.codecs.params import StreamParameters as SP

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=48, restart_every=2, major_sync_every=2,
                         seed=9, fir_across_restart=False,
                         params_update_prob=0.0, codebook_choices=choices)
    stream = synth_mlp_stream(cfg)
    params = SP(BPS_CODE[cfg.bits_per_sample], 0xF,
                RATE_CODE[cfg.sample_rate], 0xF, cfg.channel_assignment)
    # pin the expectation: with (0,) every parsed block is codebook-free
    inc = host.parse_mlp_stream_begin(stream, skip_values=True, sub_every=8)
    assert inc is not None
    inc.step(0)
    v = inc.view()
    assert v.status == 0
    if choices == (0,):
        for s in range(v.substream_count):
            assert not v.sub[s]["codebook"].any()
        # fixed-rate sub-lane offsets are affine within each block
        for s in range(v.substream_count):
            sub = v.sub[s]
            per = -(-int(sub["len"][0]) // 8)
            bp = np.asarray(sub["sub_bitpos"][: per * 4]).reshape(4, per)
            if per > 1:
                d = np.diff(bp, axis=1)
                assert (d == d[:, :1]).all()
    inc.close()
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                      config=DecodeConfig(device_huffman=True))
    assert b is not None and np.array_equal(a, b)


def test_device_huffman_nonuniform_falls_back():
    """Non-uniform streams under device_huffman re-parse in value mode and
    still decode bit-exactly through the general path."""
    from dvda.codecs.mlp.native_engine import decode_native
    from dvda.codecs.mlp.spec import MlpDecoder
    from dvda.config import DecodeConfig
    from dvda.testutil.mlp_synth import synth_two_section_stream
    from dvda.testutil.synth import BPS_CODE, RATE_CODE
    from dvda.codecs.params import StreamParameters as SP

    stream, cfg = synth_two_section_stream()
    params = SP(BPS_CODE[cfg.bits_per_sample], 0xF,
                RATE_CODE[cfg.sample_rate], 0xF, cfg.channel_assignment)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                      config=DecodeConfig(device_huffman=True))
    assert b is not None and np.array_equal(a, b)


def test_codebook_arith_decode_matches_luts_exhaustively():
    """The kernel's arithmetic (value, length) formulas equal the peek
    LUTs for every valid 9-bit peek of all three codebooks (invalid
    codes excluded — the host parser rejects those streams)."""
    import jax.numpy as jnp

    from dvda.ops.huffman_decode import codebook_arith_decode

    p = jnp.arange(512, dtype=jnp.int32)
    for cb in (1, 2, 3):
        vals, lens = peek_lut(cb)
        v, n = codebook_arith_decode(jnp.full(512, cb == 1),
                                     jnp.full(512, cb == 2),
                                     jnp.full(512, cb == 3), p)
        valid = lens != 0
        assert np.array_equal(np.asarray(v)[valid], vals[valid]), cb
        assert np.array_equal(np.asarray(n)[valid], lens[valid]), cb


def test_device_huffman_multi_section_pipelined():
    """A piecewise-uniform stream (block-size switch at a clean restart)
    under device_huffman decodes through the SECTIONED pipelined path —
    exercising the per-section sub_bitpos offset carry — bit-exactly vs
    the spec decoder."""
    from dvda.codecs.mlp import native_engine as ne
    from dvda.codecs.mlp.native_engine import decode_native
    from dvda.codecs.mlp.spec import MlpDecoder
    from dvda.config import DecodeConfig
    from dvda.testutil.synth import BPS_CODE, RATE_CODE
    from dvda.codecs.params import StreamParameters as SP

    base = dict(channel_assignment=17, substream_count=2, sample_rate=48000,
                bits_per_sample=24, restart_every=2, major_sync_every=2,
                fir_across_restart=False, params_update_prob=0.0)
    c1 = MlpSynthConfig(block_size=16, seed=3, n_frames=40, **base)
    c2 = MlpSynthConfig(block_size=32, seed=4, n_frames=20, **base)
    stream = synth_mlp_stream(c1) + synth_mlp_stream(c2)
    params = SP(BPS_CODE[c1.bits_per_sample], 0xF,
                RATE_CODE[c1.sample_rate], 0xF, c1.channel_assignment)
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    a = spec.take_frames()
    b = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                      config=DecodeConfig(device_huffman=True,
                                          chunk_chains=8))
    assert b is not None and np.array_equal(a, b)
    # the sectioned path (not the value-mode fallback) must have run:
    # two sections, several small chunks
    assert ne._LAST_PIPELINE_INFO.get("sections") == 2, ne._LAST_PIPELINE_INFO


def test_kernel_worst_case_39_bit_symbols():
    """Hand-built bitstreams that pin the fused burst slot's widest
    symbol: nbyp = 6 bypass bits + a 9-bit code + 24 LSB bits = 39 bits
    from one fetch (the third-window-word path), across all 32 start-bit
    alignments, vs the independent numpy spec."""
    vals, lens = _luts()
    rng = np.random.default_rng(11)
    # valid codebook-1 codes incl. the longest (9-bit) classes
    CB1 = ["111", "100", "000000001", "010000001", "011", "01001", "001"]
    # valid codebook-3 codes incl. the 1-bit short prefix
    CB3 = ["1", "001", "010000001", "0001"]
    n_ch, NB, S0, k = 2, 3, 8, 4
    for align in range(32):
        bits = "1" * align          # sweep block-0 start alignment
        res_bitpos, sub_rel = [], []
        for b in range(NB):
            res_bitpos.append(len(bits))
            rel = []
            for i in range(S0):
                if i % k == 0:
                    rel.append(len(bits) - res_bitpos[-1])
                bits += "".join(rng.choice(["0", "1"], 6))      # bypass
                bits += str(rng.choice(CB1)) + "".join(
                    rng.choice(["0", "1"], 24))                 # ch0
                bits += str(rng.choice(CB3)) + "".join(
                    rng.choice(["0", "1"], 12))                 # ch1
            sub_rel.append(rel)
        stream = bytes(
            int(bits[i : i + 8].ljust(8, "0"), 2)
            for i in range(0, len(bits), 8))
        sub = {
            "NB": NB,
            "codebook": np.tile(np.array([[1, 3]], np.int32), (NB, 1)),
            "lsb_bits": np.tile(np.array([[24, 12]], np.int32), (NB, 1)),
            "res_offset": np.tile(np.array([[-5, 3]], np.int32), (NB, 1)),
            "quant": np.tile(np.array([[2, 0]], np.int32), (NB, 1)),
            "len": np.full(NB, S0, np.int32),
            "res_bitpos": np.array(res_bitpos, np.int32),
            "byp_mask": np.full(NB, 0b111111, np.int32),  # all 6 slots
        }
        res_np, byp_np = decode_residuals_numpy(stream, sub, vals, lens)

        from dvda.codecs.mlp.native_engine import _window_rows

        span = max(r[1] - r[0] for r in sub_rel) + 45 * k  # generous
        NW = _window_rows(span)
        words = _stream_words(stream)
        wpad = np.zeros(-len(words) % NW + NW, np.uint32)
        bp = (np.array(res_bitpos, np.int32)[:, None]
              + np.array(sub_rel, np.int32))
        res_d, byp_d = decode_residuals_device(
            jnp.asarray(np.concatenate([words, wpad])),
            jnp.asarray(bp),
            jnp.asarray(sub["codebook"]), jnp.asarray(sub["lsb_bits"]),
            jnp.asarray(sub["res_offset"]), jnp.asarray(sub["quant"]),
            jnp.asarray(np.full(NB, 6, np.int32)),
            S0, n_ch + 1, k, NW)
        res_d = np.asarray(res_d).transpose(1, 0, 2)
        assert np.array_equal(res_d, res_np), align
        byp_d = np.asarray(byp_d)
        for b in range(NB):
            for m in range(6):
                assert np.array_equal((byp_d[b] >> (5 - m)) & 1,
                                      byp_np[b, :, m]), (align, b, m)
