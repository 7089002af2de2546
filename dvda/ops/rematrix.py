"""Batched MLP channel rematrixing — ★hot kernel #2.

Reference analog: rematrix_channels (mlp.c:1308-1358).  Per frame, up to 6
matrices are applied **sequentially** (each replaces one channel in place
and later matrices see the update), each a ≤(channels+2)-term dot over the
frame's channels plus two LFSR noise channels, with 64-bit accumulation,
``>> 14`` truncation to int32, quant-step masking and a bypassed-LSB add.

Device formulation: frames are batched on the leading axis ([F, L, C]
padded to the batch maxima), the 6 matrix applications unroll statically
with per-frame active masks, and each application is a vectorised
limb-exact dot over the channel axis — elementwise work across F×L.

The output stage (output shifts + RIFF WAVE channel permutation,
mlp.c:514-533) is fused here as well.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .exact_int import limb_dot, mask_quant_i32, shift_right_trunc32

__all__ = ["rematrix_frames", "apply_output_stage",
           "rematrix_frames_tl", "apply_output_stage_tl"]

MAX_MATRICES = 6


@partial(jax.jit, static_argnums=(8,))
def rematrix_frames(
    channels,     # int32 [F, L, C]
    noise,        # int32 [F, L, 2]  (already << noise_shift)
    mat_coeff,    # int32 [F, 6, C]  channel coefficients (0 beyond mmc)
    mat_noise,    # int32 [F, 6, 2]  noise-channel coefficients
    mat_out,      # int32 [F, 6]     output channel index
    mat_active,   # bool  [F, 6]
    mat_quant,    # int32 [F, 6]     quant_step_size[out_channel]
    bypassed,     # int32 [F, 6, L]
    n_mats: int = MAX_MATRICES,  # static: highest active slot + 1 over
                                 # the batch (callers know it host-side;
                                 # inactive slots beyond it are no-ops)
):
    """Apply the per-frame matrix chain; returns updated channels."""
    F, L, C = channels.shape
    cidx = jnp.arange(C, dtype=jnp.int32)

    for m in range(n_mats):
        co = mat_coeff[:, m, :][:, None, :]           # [F, 1, C]
        l0, l1, l2, l3 = limb_dot(co, channels)       # [F, L]
        n0, n1, n2, n3 = limb_dot(mat_noise[:, m, :][:, None, :], noise)
        shifted = shift_right_trunc32(
            (l0 + n0, l1 + n1, l2 + n2, l3 + n3), jnp.int32(14)
        )
        val = mask_quant_i32(shifted, mat_quant[:, m][:, None]) \
            + bypassed[:, m, :]                       # [F, L]
        sel = (cidx[None, None, :] == mat_out[:, m][:, None, None]) \
            & mat_active[:, m][:, None, None]
        channels = jnp.where(sel, val[:, :, None], channels)
    return channels


@partial(jax.jit, static_argnums=(8,))
def rematrix_frames_tl(
    channels,     # int32 [Fc, L, C, Bc]  (chains on the minor/lane axis)
    noise,        # int32 [Fc, L, 2, Bc]
    mat_coeff,    # int32 [Fc, 6, C, Bc]
    mat_noise,    # int32 [Fc, 6, 2, Bc]
    mat_out,      # int32 [Fc, 6, Bc]
    mat_active,   # bool  [Fc, 6, Bc]
    mat_quant,    # int32 [Fc, 6, Bc]
    bypassed,     # int32 [Fc, L, 6, Bc]
    n_mats: int = MAX_MATRICES,
):
    """Time-leading :func:`rematrix_frames`: the frame batch [F, L, C]
    factors as F = Bc·Fc with the C channels on a major axis and the Bc
    restart chains minor.  Bit-identical semantics; with chains minor the
    uniform pipeline needs no stream-size permute around it."""
    Fc, L, C, Bc = channels.shape
    cidx = jnp.arange(C, dtype=jnp.int32)

    for m in range(n_mats):
        co = mat_coeff[:, m][:, None]                  # [Fc, 1, C, Bc]
        l0, l1, l2, l3 = limb_dot(co, channels, axis=2)        # [Fc,L,Bc]
        n0, n1, n2, n3 = limb_dot(mat_noise[:, m][:, None], noise, axis=2)
        shifted = shift_right_trunc32(
            (l0 + n0, l1 + n1, l2 + n2, l3 + n3), jnp.int32(14)
        )
        val = mask_quant_i32(shifted, mat_quant[:, m][:, None]) \
            + bypassed[:, :, m]                        # [Fc, L, Bc]
        sel = (cidx[None, None, :, None] == mat_out[:, m][:, None, None]) \
            & mat_active[:, m][:, None, None]
        channels = jnp.where(sel, val[:, :, None], channels)
    return channels


@jax.jit
def apply_output_stage_tl(
    channels,      # int32 [Fc, L, C, Bc]
    output_shift,  # int32 [Fc, C, Bc]
    wave_perm,     # int32 [C_out]
):
    """Time-leading :func:`apply_output_stage`; returns [Fc, L, C_out, Bc]."""
    shifted = channels << output_shift[:, None]
    return jnp.take(shifted, wave_perm, axis=2)


@jax.jit
def apply_output_stage(
    channels,      # int32 [F, L, C]
    output_shift,  # int32 [F, C]  (values already masked &31 by the planner)
    wave_perm,     # int32 [C_out] — WAVE slot c comes from MLP channel wave_perm[c]
):
    """Output shifts then RIFF WAVE channel permutation (mlp.c:514-533)."""
    shifted = channels << output_shift[:, None, :]
    return jnp.take(shifted, wave_perm, axis=2)  # [F, L, C_out]
