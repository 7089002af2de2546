"""The fused decode step — the framework's "flagship forward step" — and
its multi-chip sharded variant.

One step = the full MLP device pipeline on a batch of restart-aligned
frames: batched AR filtering (ops/mlp_filter.py), channel rematrixing with
LFSR noise, output shifts and WAVE permutation (ops/rematrix.py).  This is
exactly the computation the track/disc decoders dispatch; here it is
packaged as a single jittable function over a :class:`DecodeBatch` so the
driver can compile-check it and dry-run the sharded version.

Sharding (see parallel/mesh.py): filter lanes are (frame × channel) and
shard over ``(dp, tp)``; the rematrix needs every channel of a frame, so
the channel axis is gathered (XLA inserts the all-gather over ``tp``)
while frames stay sharded over ``dp``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.mlp_filter import mlp_filter_blocks
from ..ops.rematrix import apply_output_stage, rematrix_frames
from .mesh import AXIS_CHANNEL, AXIS_DATA

__all__ = ["DecodeBatch", "decode_step", "make_sharded_step",
           "batch_shardings", "example_batch"]


class DecodeBatch(NamedTuple):
    """Inputs for one fused decode step over F frames × C channels.

    Frame f's channel c is filter lane ``f*C + c``; L = NB·S samples.
    """

    residuals: jax.Array   # int32 [F, C, NB, S]
    rc_fir: jax.Array      # int32 [F, C, NB, 8]
    rc_iir: jax.Array      # int32 [F, C, NB, 8]
    shift: jax.Array       # int32 [F, C, NB]
    quant: jax.Array       # int32 [F, C, NB]
    iir_reset: jax.Array   # bool  [F, C, NB]
    iir_init: jax.Array    # int32 [F, C, NB, 8]
    block_len: jax.Array   # int32 [F, C, NB]
    noise: jax.Array       # int32 [F, L, 2]
    mat_coeff: jax.Array   # int32 [F, 6, C]
    mat_noise: jax.Array   # int32 [F, 6, 2]
    mat_out: jax.Array     # int32 [F, 6]
    mat_active: jax.Array  # bool  [F, 6]
    mat_quant: jax.Array   # int32 [F, 6]
    bypassed: jax.Array    # int32 [F, 6, L]
    output_shift: jax.Array  # int32 [F, C]
    wave_perm: jax.Array   # int32 [C_out]


def decode_step(b: DecodeBatch) -> jax.Array:
    """Filter → rematrix → output; returns int32 [F, L, C_out]."""
    F, C, NB, S = b.residuals.shape

    def flat(x):
        return x.reshape((F * C,) + x.shape[2:])

    out, _, _ = mlp_filter_blocks(
        flat(b.residuals), flat(b.rc_fir), flat(b.rc_iir), flat(b.shift),
        flat(b.quant), flat(b.iir_reset), flat(b.iir_init), flat(b.block_len),
        jnp.zeros((F * C, 8), jnp.int32), jnp.zeros((F * C, 8), jnp.int32),
    )
    channels = out.reshape(F, C, NB * S).transpose(0, 2, 1)  # [F, L, C]
    channels = rematrix_frames(channels, b.noise, b.mat_coeff, b.mat_noise,
                               b.mat_out, b.mat_active, b.mat_quant,
                               b.bypassed)
    return apply_output_stage(channels, b.output_shift, b.wave_perm)


def batch_shardings(mesh) -> DecodeBatch:
    """Input shardings: frames over dp, channels over tp; frame-level
    tensors over dp only."""
    fc = NamedSharding(mesh, P(AXIS_DATA, AXIS_CHANNEL))
    f = NamedSharding(mesh, P(AXIS_DATA))
    rep = NamedSharding(mesh, P())
    return DecodeBatch(
        residuals=fc, rc_fir=fc, rc_iir=fc, shift=fc, quant=fc,
        iir_reset=fc, iir_init=fc, block_len=fc,
        noise=f, mat_coeff=f, mat_noise=f, mat_out=f, mat_active=f,
        mat_quant=f, bypassed=f, output_shift=f, wave_perm=rep,
    )


def make_sharded_step(mesh):
    """jit ``decode_step`` over the mesh: filter runs channel-sharded (tp),
    XLA gathers channels for the rematrix, frames stay dp-sharded."""

    def step(b: DecodeBatch) -> jax.Array:
        F, C = b.residuals.shape[:2]

        def flat(x):
            return x.reshape((F * C,) + x.shape[2:])

        out, _, _ = mlp_filter_blocks(
            flat(b.residuals), flat(b.rc_fir), flat(b.rc_iir), flat(b.shift),
            flat(b.quant), flat(b.iir_reset), flat(b.iir_init),
            flat(b.block_len),
            jnp.zeros((F * C, 8), jnp.int32), jnp.zeros((F * C, 8), jnp.int32),
        )
        NBS = out.shape[1] * out.shape[2]
        channels = out.reshape(F, C, NBS).transpose(0, 2, 1)
        # rematrix couples channels: gather them (all-gather over tp)
        channels = jax.lax.with_sharding_constraint(
            channels, NamedSharding(mesh, P(AXIS_DATA, None, None))
        )
        channels = rematrix_frames(channels, b.noise, b.mat_coeff,
                                   b.mat_noise, b.mat_out, b.mat_active,
                                   b.mat_quant, b.bypassed)
        return apply_output_stage(channels, b.output_shift, b.wave_perm)

    return jax.jit(
        step,
        in_shardings=(batch_shardings(mesh),),
        out_shardings=NamedSharding(mesh, P(AXIS_DATA)),
    )


def example_batch(F: int = 8, C: int = 8, NB: int = 4, S: int = 16,
                  C_out: int = 6, seed: int = 0) -> DecodeBatch:
    """A random-but-valid batch honouring the kernels' invariants
    (17-bit coefficients, 16-bit matrix coefficients, shifts in range)."""
    rng = np.random.default_rng(seed)
    L = NB * S

    def i32(*shape, lo, hi):
        return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)

    batch = DecodeBatch(
        residuals=i32(F, C, NB, S, lo=-(1 << 16), hi=1 << 16),
        rc_fir=i32(F, C, NB, 8, lo=-(1 << 10), hi=1 << 10),
        rc_iir=i32(F, C, NB, 8, lo=-(1 << 10), hi=1 << 10),
        shift=i32(F, C, NB, lo=8, hi=14),
        quant=i32(F, C, NB, lo=0, hi=3),
        iir_reset=rng.random((F, C, NB)) < 0.2,
        iir_init=i32(F, C, NB, 8, lo=-(1 << 12), hi=1 << 12),
        block_len=np.full((F, C, NB), S, dtype=np.int32),
        noise=i32(F, L, 2, lo=-(1 << 10), hi=1 << 10),
        mat_coeff=i32(F, 6, C, lo=-(1 << 12), hi=1 << 12),
        mat_noise=i32(F, 6, 2, lo=-(1 << 12), hi=1 << 12),
        mat_out=i32(F, 6, lo=0, hi=C_out),
        mat_active=rng.random((F, 6)) < 0.7,
        mat_quant=i32(F, 6, lo=0, hi=3),
        bypassed=i32(F, 6, L, lo=0, hi=2),
        output_shift=i32(F, C, lo=0, hi=3),
        wave_perm=np.arange(C_out, dtype=np.int32),
    )
    return DecodeBatch(*(jnp.asarray(x) for x in batch))
