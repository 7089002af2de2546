"""Exact C-integer arithmetic via int32 limb decomposition.

The MLP hot loops accumulate products in C ``int64`` and then truncate to
``int32`` after an arithmetic shift (filter_channel mlp.c:1278-1300,
rematrix_channels :1338-1355).  JAX runs with 64-bit types off by default
(``jax_enable_x64`` is process-global), so the kernels here stay in int32
and decompose each 32-bit operand into four 8-bit limbs:

    v = b0 + b1·2^8 + b2·2^16 + b3·2^24      (b0..b2 unsigned, b3 signed)

With coefficients bounded to 17 signed bits (MLP guarantees: filter coeffs
are ≤16-bit values shifted ≤ a total of 16 bits, mlp.c:1043-1047; matrix
coeffs are (frac+2 ≤ 16)-bit values shifted to 14 fractional bits,
mlp.c:1016-1019), every limb product fits comfortably in int32
(2^16 · 2^8 = 2^24), and sums of ≤16 taps stay under 2^28.  The final
``(int32)(acc >> shift)`` is reconstructed exactly with wrapping int32
arithmetic — bit-identical to the C semantics for *any* int32 inputs, not
just well-behaved audio.

All functions are jnp-traceable and shape-polymorphic over leading dims.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["limb_dot", "shift_right_trunc32", "mask_quant_i32"]

# NB: this module deliberately contains no module-level jnp values: arrays
# captured from outside a trace become hoisted executable constants, and
# jax 0.9's CPU runtime can drop them between jit cache hits ("Execution
# supplied N buffers but compiled program expected N+1").  Python ints
# trace as inlined literals instead.
_FF = 0xFF


def limb_dot(coeff, values, axis: int = -1):
    """Σ coeff·values as four int32 limb sums ``(S0, S1, S2, S3)``.

    ``coeff`` must fit 17 signed bits; ``values`` is any int32.  The true
    64-bit sum is ``S0 + S1·2^8 + S2·2^16 + S3·2^24``.
    """
    b0 = values & _FF
    b1 = (values >> 8) & _FF
    b2 = (values >> 16) & _FF
    b3 = values >> 24  # arithmetic: signed top limb
    s0 = jnp.sum(coeff * b0, axis=axis)
    s1 = jnp.sum(coeff * b1, axis=axis)
    s2 = jnp.sum(coeff * b2, axis=axis)
    s3 = jnp.sum(coeff * b3, axis=axis)
    return s0, s1, s2, s3


def shift_right_trunc32(limbs, shift):
    """``(int32)(acc >> shift)`` for a limb-decomposed int64 accumulator.

    ``shift`` is an int32 array (broadcastable) in [0, 24].  Carries are
    propagated limb-to-limb with arithmetic shifts; the final combine uses
    wrapping int32 ops, matching the C truncating cast exactly.
    """
    s0, s1, s2, s3 = limbs
    c0 = s0 >> 8
    r0 = s0 & _FF
    t1 = s1 + c0
    c1 = t1 >> 8
    r1 = t1 & _FF
    t2 = s2 + c1
    c2 = t2 >> 8
    r2 = t2 & _FF
    t3 = s3 + c2
    low = (r2 << 16) | (r1 << 8) | r0  # exact low 24 bits, non-negative
    return (t3 << (24 - shift)) + (low >> shift)


def mask_quant_i32(x, q):
    """Zero the low ``q`` bits (mask(), mlp.c:246-253); q may be per-element."""
    return (x >> q) << q
