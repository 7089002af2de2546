"""The triton AR-filter kernel (ops/triton_filter.py) against the
lax.scan filter: in the Pallas interpreter on the CPU, and compiled on a
GPU (tests marked ``gpu``, run by chip_smoke.py on the card)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dvda.ops.mlp_filter import mlp_filter_blocks
from dvda.ops.triton_filter import mlp_filter_blocks_triton


def _random_args(seed, B, NB, S, extreme=False, ragged=0.2, reset=0.3):
    rng = np.random.default_rng(seed)
    if extreme:  # pathological int32 inputs: the limbs must stay exact
        res = rng.integers(-2**31, 2**31 - 1, (B, NB, S))
        coeff = (-2**15, 2**15)
        init = rng.integers(-2**28, 2**28, (B, NB, 8))
        shift = rng.integers(0, 16, (B, NB))
        quant = rng.integers(0, 16, (B, NB))
    else:
        res = rng.integers(-3000, 3000, (B, NB, S))
        coeff = (-900, 900)
        init = rng.integers(-5000, 5000, (B, NB, 8))
        shift = rng.integers(8, 13, (B, NB))
        quant = rng.integers(0, 3, (B, NB))
    fir = rng.integers(*coeff, (B, NB, 8))
    iir = rng.integers(*coeff, (B, NB, 8))
    irst = rng.random((B, NB)) < reset
    blen = np.where(rng.random((B, NB)) < ragged,
                    rng.integers(0, S + 1, (B, NB)), S)
    return tuple(jnp.asarray(np.asarray(x).astype(
        bool if x is irst else np.int32))
        for x in (res, fir, iir, shift, quant, irst, init, blen))


def _compare(args, **kw):
    """Run both filters; compare the samples inside each block's length
    (the scan leaves garbage past it, the kernel the same values)."""
    res = args[0]
    B, NB, S = res.shape
    zero = jnp.zeros((B, 8), jnp.int32)
    ref, _, _ = mlp_filter_blocks(*args, zero, zero)
    got = mlp_filter_blocks_triton(jnp.moveaxis(res, 0, -1), *args[1:],
                                   **kw)
    got = np.moveaxis(np.asarray(got), -1, 0)
    assert got.shape == (B, NB, S)
    blen = np.asarray(args[7])
    mask = np.arange(S)[None, None, :] < blen[:, :, None]
    np.testing.assert_array_equal(np.asarray(ref)[mask], got[mask])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triton_matches_scan(seed):
    _compare(_random_args(seed, 128, 4, 16), interpret=True)


def test_triton_extreme_values():
    _compare(_random_args(9, 128, 2, 8, extreme=True, ragged=0.0,
                          reset=0.5), interpret=True)


def test_triton_ragged_blocks_with_resets():
    """Most blocks shorter than S (state frozen past the length, zero-
    length blocks included) and IIR resets in most blocks."""
    _compare(_random_args(4, 128, 6, 12, ragged=0.8, reset=0.7),
             interpret=True)


def test_triton_lane_count_not_a_block_multiple():
    """200 lanes: the wrapper pads to two 128-lane programs and drops
    the pad."""
    _compare(_random_args(5, 200, 3, 10), interpret=True)


def test_triton_fewer_lanes_than_a_block():
    """40 lanes: one program, mostly padding."""
    _compare(_random_args(6, 40, 3, 8), interpret=True)


def test_triton_refuses_non_gpu_backend_without_interpret():
    args = _random_args(0, 128, 1, 8)
    with pytest.raises(ValueError, match="GPU backend"):
        mlp_filter_blocks_triton(jnp.moveaxis(args[0], 0, -1), *args[1:])


def _synth_stream():
    from dvda.codecs.params import StreamParameters
    from dvda.testutil.mlp_synth import MlpSynthConfig, synth_mlp_stream
    from dvda.testutil.synth import BPS_CODE, RATE_CODE

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=32, restart_every=2, major_sync_every=2,
                         seed=8, fir_across_restart=False,
                         params_update_prob=0.0)
    params = StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                              RATE_CODE[cfg.sample_rate], 0xF,
                              cfg.channel_assignment)
    return synth_mlp_stream(cfg), params


def _decode(stream, params, cfg):
    from dvda import host
    from dvda.codecs.mlp.native_engine import decode_native

    if not host.available():
        pytest.skip("native host library unavailable")
    out = decode_native(stream, np.zeros(0, np.int64), len(stream), params,
                        config=cfg)
    assert out is not None
    return out


def test_pipeline_with_triton_filter_bit_exact():
    """filter_kernel="triton" routes the chunk program's filter through
    the kernel (interpreted here) with output identical to the scan."""
    from dvda.config import DecodeConfig

    stream, params = _synth_stream()
    scan = _decode(stream, params, DecodeConfig(filter_kernel="scan",
                                                host_complete=False))
    kern = _decode(stream, params, DecodeConfig(
        filter_kernel="triton", filter_interpret=True, host_complete=False))
    np.testing.assert_array_equal(scan, kern)


def test_filter_kernel_resolution(monkeypatch):
    """Auto picks the kernel only on a GPU backend; asking for it
    elsewhere without filter_interpret raises; unknown names raise."""
    import jax

    from dvda.config import DecodeConfig

    assert DecodeConfig().resolved_filter_kernel() == "scan"
    assert DecodeConfig(filter_kernel="scan").resolved_filter_kernel() \
        == "scan"
    assert DecodeConfig(filter_kernel="triton", filter_interpret=True) \
        .resolved_filter_kernel() == "triton-interpret"
    with pytest.raises(ValueError, match="GPU backend"):
        DecodeConfig(filter_kernel="triton").resolved_filter_kernel()
    with pytest.raises(ValueError, match="filter_kernel"):
        DecodeConfig(filter_kernel="pallas").resolved_filter_kernel()
    monkeypatch.setenv("DVDA_FILTER_KERNEL", "scan")
    assert DecodeConfig.from_env().filter_kernel == "scan"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert DecodeConfig().resolved_filter_kernel() == "triton"
    assert DecodeConfig(filter_kernel="triton").resolved_filter_kernel() \
        == "triton"


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1536, 2048])
def test_triton_compiled_matches_scan(gpu, lanes):
    """The compiled kernel at the production chunk shape (16 × 40)."""
    _compare(_random_args(lanes, lanes, 16, 40))


@pytest.mark.gpu
def test_pipeline_compiled_triton_matches_scan(gpu):
    from dvda.config import DecodeConfig

    stream, params = _synth_stream()
    scan = _decode(stream, params, DecodeConfig(filter_kernel="scan",
                                                host_complete=False))
    kern = _decode(stream, params, DecodeConfig(filter_kernel="triton",
                                                host_complete=False))
    np.testing.assert_array_equal(scan, kern)
