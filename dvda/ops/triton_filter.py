"""MLP AR reconstruction filter as one GPU kernel (Pallas through Triton).

Same computation as ops/mlp_filter.py (filter_channel, mlp.c:1243-1306 —
see there for semantics).  The lax.scan version runs the time recursion
as an XLA loop, which on a GPU costs at least one kernel launch per
sample step (640 steps per chunk at the 5.1 / 96 kHz shape).  Here the
whole recursion runs inside one kernel:

* one lane (chain × channel) per vector element, ``BLOCK`` lanes per
  program; programs are independent, so the grid spreads over the SMs;
* the 8 FIR and 8 IIR state words are carried as 16 ``[BLOCK]`` int32
  vectors through ``fori_loop`` — they stay in registers, no scratch
  memory and no shifting of a state array;
* per-block coefficients, shift, quant, IIR reset, IIR init state and
  block length are loaded once per block;
* residuals are read and outputs written in the time-leading
  ``[NB·S, B]`` layout, so at every step a warp touches consecutive lanes
  (coalesced); S = 40 is not a power of two, so time is flattened and
  each step addresses its row directly;
* arithmetic is the exact int64-via-int32 limb decomposition of
  ops/exact_int.py, bit-identical to the scan.

``mlp_filter_blocks_triton`` matches ``mlp_filter_blocks`` (zero initial
state) bit for bit.  It compiles only for a GPU; ``interpret=True`` runs
it in the Pallas interpreter on any backend, which is how the CPU tests
reach it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .exact_int import mask_quant_i32, shift_right_trunc32

__all__ = ["mlp_filter_blocks_triton"]

#: lanes per program and warps per program: on an H100 at the 1 536-lane
#: chunk shape 128 × 4 measured fastest of 32×1, 64×2, 128×4, 256×8 and
#: 128×1 (PERF.md, Findings)
BLOCK = 128
NUM_WARPS = 4

_TAPS = 8


def _limb_sums(coeffs, states):
    """Σ coeff·state over the taps as four int32 limb sums (exact_int.
    limb_dot with the taps unrolled over separate vectors)."""
    s = [0, 0, 0, 0]
    for c, v in zip(coeffs, states):
        s[0] = s[0] + c * (v & 0xFF)
        s[1] = s[1] + c * ((v >> 8) & 0xFF)
        s[2] = s[2] + c * ((v >> 16) & 0xFF)
        s[3] = s[3] + c * (v >> 24)
    return s


def _kernel(res_ref, fir_ref, iir_ref, shift_ref, quant_ref, irst_ref,
            init_ref, blen_ref, out_ref):
    NB = fir_ref.shape[0]
    S = res_ref.shape[0] // NB
    zero = jnp.zeros(res_ref.shape[1:], jnp.int32)

    def block_body(b, carry):
        fir_st, iir_st = carry
        fir_c = [fir_ref[b, k, :] for k in range(_TAPS)]
        iir_c = [iir_ref[b, k, :] for k in range(_TAPS)]
        shift = shift_ref[b, :]
        quant = quant_ref[b, :]
        blen = blen_ref[b, :]
        # IIR state injection at reset blocks (mlp.c:1098-1108)
        reset = irst_ref[b, :] != 0
        iir_st = tuple(jnp.where(reset, init_ref[b, k, :], iir_st[k])
                       for k in range(_TAPS))

        def sample_body(i, st):
            fs, is_ = st
            f = _limb_sums(fir_c, fs)
            g = _limb_sums(iir_c, is_)
            shifted = shift_right_trunc32(
                tuple(a + c for a, c in zip(f, g)), shift)
            t = b * S + i
            value = mask_quant_i32(shifted + res_ref[t, :], quant)
            out_ref[t, :] = value
            # state index 7 is the most recent sample; lanes past their
            # block length keep their state frozen
            valid = i < blen
            nfs = fs[1:] + (value,)
            nis = is_[1:] + (value - shifted,)
            return (tuple(jnp.where(valid, n, o) for n, o in zip(nfs, fs)),
                    tuple(jnp.where(valid, n, o) for n, o in zip(nis, is_)))

        return jax.lax.fori_loop(0, S, sample_body, (fir_st, iir_st))

    zeros = (zero,) * _TAPS
    jax.lax.fori_loop(0, NB, block_body, (zeros, zeros))


def _lanes_last(x, B_pad):
    """[B, NB, ...] → [NB, ..., B_pad] (lanes minor, zero-padded)."""
    x = jnp.moveaxis(x, 0, -1)
    pad = B_pad - x.shape[-1]
    if pad:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return x


@partial(jax.jit, static_argnames=("interpret",))
def mlp_filter_blocks_triton(
    residuals_tl,  # int32 [NB, S, B]  time-leading (lanes minor)
    rc_fir,        # int32 [B, NB, 8]  reversed taps (index 7 ↔ most recent)
    rc_iir,        # int32 [B, NB, 8]
    shift,         # int32 [B, NB]
    quant,         # int32 [B, NB]
    iir_reset,     # bool  [B, NB]
    iir_init,      # int32 [B, NB, 8]
    block_len,     # int32 [B, NB]
    interpret: bool = False,
):
    """Kernel variant of ops.mlp_filter.mlp_filter_blocks_tl with zero
    initial states; returns out_tl [NB, S, B].  Any lane count works:
    lanes are padded to a multiple of ``BLOCK`` and the pad is dropped.

    Raises on a non-GPU backend unless ``interpret=True``: the kernel has
    no other compiled form, and interpretation is never chosen silently."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the triton AR-filter kernel compiles only for a GPU backend "
            f"(default backend is {jax.default_backend()!r}); use the "
            "'scan' filter there, or pass interpret=True")
    NB, S, B = residuals_tl.shape
    B_pad = -(-B // BLOCK) * BLOCK
    res = residuals_tl.reshape(NB * S, B)
    if B_pad != B:
        res = jnp.pad(res, ((0, 0), (0, B_pad - B)))
    ins = (
        res,
        _lanes_last(rc_fir, B_pad),                      # [NB, 8, B_pad]
        _lanes_last(rc_iir, B_pad),
        _lanes_last(shift, B_pad),                       # [NB, B_pad]
        _lanes_last(quant, B_pad),
        _lanes_last(iir_reset.astype(jnp.int32), B_pad),
        _lanes_last(iir_init, B_pad),
        _lanes_last(block_len, B_pad),
    )

    def spec(x):
        return pl.BlockSpec(x.shape[:-1] + (BLOCK,),
                            lambda i, n=x.ndim: (0,) * (n - 1) + (i,))

    out = pl.pallas_call(
        _kernel,
        out_shape=jax.ShapeDtypeStruct((NB * S, B_pad), jnp.int32),
        grid=(B_pad // BLOCK,),
        in_specs=[spec(x) for x in ins],
        out_specs=spec(res),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="mlp_ar_filter",
    )(*ins)
    return out[:, :B].reshape(NB, S, B)
