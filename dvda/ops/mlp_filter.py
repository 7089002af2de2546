"""Batched MLP FIR/IIR reconstruction filter — the ★hot kernel.

Reference analog: filter_channel (mlp.c:1243-1306), a per-sample scalar
loop.  Device formulation: the recurrence is inherently sequential in time
(the "FIR" taps read *previous outputs*, i.e. it is an AR filter with a
floor nonlinearity, so no exact parallel scan exists), but it is
embarrassingly parallel across **lanes** — (chain × channel) pairs — which
is where the throughput comes from: the planner splits each track into
independent restart chains (dvda/codecs/mlp/planner.py) and a whole
disc's chains decode in one batched scan.

Layout:
  * lanes ``B`` on the leading axis; time runs as [NB blocks × S samples]
    with per-block parameters (coefficients may change at any block);
  * state vectors are 8 wide, index 7 = most recent sample; coefficient
    rows are pre-reversed by the planner so the tap dot product is a plain
    elementwise dot with the state vector;
  * FIR state carries across everything (the reference never resets it,
    see spec.py); IIR state is replaced at blocks with ``iir_reset`` using
    the explicitly-coded state (mlp.c:1098-1108);
  * per-sample masking (``pos < block_len``) freezes state in padding
    lanes so ragged blocks batch cleanly.

Arithmetic is exactly C's: int64 accumulate via limb decomposition, then
``(int32)(acc >> shift)``, quant-step masking, wrapping int32 adds
(ops/exact_int.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .exact_int import limb_dot, mask_quant_i32, shift_right_trunc32

__all__ = ["mlp_filter_blocks", "mlp_filter_blocks_tl"]


def _filter_core(residuals_tl, rc_fir, rc_iir, shift, quant, iir_reset,
                 iir_init, block_len, fir_state0, iir_state0, unroll=1):
    """Shared scan core over TIME-LEADING residuals [NB, S, B]; returns
    (out_tl [NB, S, B], fir_state, iir_state).  Both scans consume their
    natural leading axis — no residual transposes inside.

    Inside the scan the 8-tap state/coefficient vectors are carried
    TAPS-LEADING ([8, B]: lanes minor), so each tap dot reduces over a
    major axis at full lane width.  External shapes stay [B, ..., 8]; the
    flips are one-time transposes of the small parameter tensors.

    This is the plain reference for the GPU kernel (ops/triton_filter.py)
    and the filter on every other backend."""
    NB, S, B = residuals_tl.shape
    pos = jnp.arange(S, dtype=jnp.int32)

    def block_step(carry, xs):
        fir_st, iir_st = carry                          # [8, B]
        res_b, fir_c, iir_c, sh, q, irst, iinit, blen = xs
        iir_st = jnp.where(irst[None, :], iinit, iir_st)

        def sample_step(st, res_i):
            fs, is_ = st
            res, valid = res_i
            l0, l1, l2, l3 = limb_dot(fir_c, fs, axis=0)
            m0, m1, m2, m3 = limb_dot(iir_c, is_, axis=0)
            shifted = shift_right_trunc32((l0 + m0, l1 + m1, l2 + m2, l3 + m3), sh)
            value = mask_quant_i32(shifted + res, q)
            nfs = jnp.concatenate([fs[1:], value[None]], axis=0)
            nis = jnp.concatenate([is_[1:], (value - shifted)[None]], axis=0)
            v = valid[None, :]
            return (jnp.where(v, nfs, fs), jnp.where(v, nis, is_)), value

        valid = pos[:, None] < blen[None, :]            # [S, B]
        (fir_st, iir_st), out = jax.lax.scan(
            sample_step,
            (fir_st, iir_st),
            (res_b, valid),  # scan over S (leading)
            unroll=unroll,
        )
        return (fir_st, iir_st), out  # [S, B]

    (fir_f, iir_f), outs = jax.lax.scan(
        block_step,
        (fir_state0.T, iir_state0.T),
        (
            residuals_tl,
            jnp.moveaxis(rc_fir, (1, 2), (0, 1)),       # [NB, 8, B]
            jnp.moveaxis(rc_iir, (1, 2), (0, 1)),
            shift.T,
            quant.T,
            iir_reset.T,
            jnp.moveaxis(iir_init, (1, 2), (0, 1)),
            block_len.T,
        ),
    )
    return outs, fir_f.T, iir_f.T  # [NB, S, B], [B, 8], [B, 8]


@partial(jax.jit, static_argnums=(10,))
def mlp_filter_blocks_tl(
    residuals_tl,  # int32 [NB, S, B]  time-leading (lanes minor)
    rc_fir,      # int32 [B, NB, 8]  reversed taps (index 7 ↔ most recent)
    rc_iir,      # int32 [B, NB, 8]
    shift,       # int32 [B, NB]
    quant,       # int32 [B, NB]
    iir_reset,   # bool  [B, NB]
    iir_init,    # int32 [B, NB, 8]
    block_len,   # int32 [B, NB]
    fir_state0,  # int32 [B, 8]
    iir_state0,  # int32 [B, 8]
    unroll: int = 1,  # static: sample-scan unroll (see _filter_core)
):
    """Time-leading entry: residuals and output stay [NB, S, B] (lanes on
    the minor axis), so neither the producer nor this filter pays a
    residual transpose."""
    return _filter_core(residuals_tl, rc_fir, rc_iir, shift, quant,
                        iir_reset, iir_init, block_len,
                        fir_state0, iir_state0, unroll)


@jax.jit
def mlp_filter_blocks(
    residuals,   # int32 [B, NB, S]
    rc_fir,      # int32 [B, NB, 8]  reversed taps (index 7 ↔ most recent)
    rc_iir,      # int32 [B, NB, 8]
    shift,       # int32 [B, NB]
    quant,       # int32 [B, NB]
    iir_reset,   # bool  [B, NB]
    iir_init,    # int32 [B, NB, 8]
    block_len,   # int32 [B, NB]
    fir_state0,  # int32 [B, 8]
    iir_state0,  # int32 [B, 8]
):
    """Run the batched filter; returns (out [B, NB, S], fir_state, iir_state)."""
    outs, fir_f, iir_f = _filter_core(
        jnp.moveaxis(residuals, (1, 2), (0, 1)), rc_fir, rc_iir, shift,
        quant, iir_reset, iir_init, block_len, fir_state0, iir_state0)
    return jnp.moveaxis(outs, (0, 1), (1, 2)), fir_f, iir_f  # [B, NB, S]
