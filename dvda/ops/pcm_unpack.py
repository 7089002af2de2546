"""Device kernel: AOB PCM byte de-swizzle + sign-extend.

Reference analog: the scalar per-byte scatter loop in
dvda_pcmdecoder_decode_packet (pcm.c:147-166) with the AOB_BYTE_SWAP tables
(pcm.c:103-138) and SL16/SL24 sign extension (pcm.c:171-193).

Device formulation: the scatter tables are inverted host-side into
per-config gather indices (codecs/pcm.pcm_gather_indices); the kernel is
then a single fused select + shift + sign-extend over a
``[n_chunks, chunk_size]`` uint8 batch — elementwise, memory-bandwidth
bound work that XLA fuses into one pass.  Plain JAX; no hand-written
kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs.pcm import pcm_gather_indices

__all__ = ["decode_chunks_device", "pcm_unpack_jit"]


@partial(jax.jit, static_argnames=("bits_per_sample", "channels"))
def _unpack(chunks: jax.Array, bits_per_sample: int, channels: int):
    """chunks: uint8 [n, chunk_size].  Returns int32 [2n, channels].

    The byte permutation is baked in as *static column selects* (the index
    tables are compile-time constants with ≤36 entries) rather than an XLA
    gather; the unrolled form lowers to plain selects/shifts that XLA fuses
    into one memory-bound pass.
    """
    idx = pcm_gather_indices(bits_per_sample, channels)  # host-side constant
    n = chunks.shape[0]
    zero = jnp.zeros((n,), dtype=jnp.int32)

    def col(j: int) -> jax.Array:
        return zero if j < 0 else chunks[:, j].astype(jnp.int32)

    samples = []
    for s in range(idx.shape[0]):
        b0, b1, b2 = int(idx[s, 0]), int(idx[s, 1]), int(idx[s, 2])
        if bits_per_sample == 16:
            val = col(b0) | (col(b1) << 8)
            val = (val ^ 0x8000) - 0x8000
        else:
            val = col(b0) | (col(b1) << 8) | (col(b2) << 16)
            val = (val ^ 0x800000) - 0x800000
        samples.append(val)
    out = jnp.stack(samples, axis=1)  # [n, 2*ch]
    return out.reshape(n * 2, channels)


def pcm_unpack_jit(bits_per_sample: int, channels: int):
    """Return a jitted ``chunks -> samples`` function for a fixed config."""

    def fn(chunks):
        return _unpack(chunks, bits_per_sample, channels)

    return fn


def decode_chunks_device(
    chunks: np.ndarray, bits_per_sample: int, channels: int
) -> jax.Array:
    """One-shot device decode of a host chunk batch."""
    return _unpack(jnp.asarray(chunks), bits_per_sample, channels)
