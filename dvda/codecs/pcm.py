"""PCM codec — host-side logic and the vectorised unpack specification.

Reference analog: src/pcm.c.  The AOB on-disc layout interleaves *two* PCM
frames per chunk with a byte order that depends on (bits-per-sample,
channels); the reference undoes it one byte at a time through the
``AOB_BYTE_SWAP`` scatter tables (pcm.c:103-138) and then sign-extends
little-endian 16/24-bit groups (SL16/SL24_char_to_int, pcm.c:171-193).

Batched formulation: scatter tables are inverted once into **gather
indices** so a whole track's chunks decode as one vectorised
``take``+shift+mask expression over a ``[n_chunks, chunk_size]`` uint8
batch — see :func:`pcm_gather_indices` (host/numpy reference here,
device kernel in dvda.ops.pcm_unpack).

Semantics notes (all mirrored from the reference):

* a chunk is ``bytes_per_sample * channels * 2`` bytes and decodes to 2 PCM
  frames (pcm.c:68, 147-166); trailing sub-chunk bytes in a packet are
  dropped (pcm.c:147);
* 20-bit streams use ``bytes_per_sample = 20 // 8 = 2`` but the 24-bit swap
  table and the 3-byte SL24 converter (pcm.c:56-62).  In the reference this
  reads bytes of ``unswapped[]`` that were never written for the chunk —
  i.e. uninitialised C stack memory (pcm.c:148-166).  We define those bytes
  as **0** instead, making 20-bit decode deterministic; 16/24-bit paths are
  bit-exact with the reference.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitReader
from .params import StreamParameters

__all__ = [
    "AOB_BYTE_SWAP",
    "parse_pcm_params",
    "chunk_size",
    "pcm_gather_indices",
    "decode_chunks_numpy",
    "payload_to_chunks",
]


# AOB_BYTE_SWAP[bps_index][channels-1] — scatter tables from pcm.c:103-138.
# bps_index 0 = 16-bit, 1 = 24-bit (20-bit uses index 1).
AOB_BYTE_SWAP: list[list[list[int]]] = [
    [  # 16 bps
        [1, 0, 3, 2],
        [1, 0, 3, 2, 5, 4, 7, 6],
        [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10],
        [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14],
        [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14, 17, 16, 19, 18],
        [5, 4, 7, 6, 17, 16, 19, 18, 1, 0, 3, 2,
         9, 8, 11, 10, 13, 12, 15, 14, 21, 20, 23, 22],
    ],
    [  # 24 bps (and 20 bps)
        [2, 1, 5, 4, 0, 3],
        [2, 1, 5, 4, 8, 7, 11, 10, 0, 3, 6, 9],
        [8, 7, 17, 16, 6, 15, 2, 1, 5, 4, 11, 10, 14, 13, 0, 3, 9, 12],
        [8, 7, 11, 10, 20, 19, 23, 22, 6, 9, 18, 21,
         2, 1, 5, 4, 14, 13, 17, 16, 0, 3, 12, 15],
        [8, 7, 11, 10, 14, 13, 23, 22, 26, 25, 29, 28,
         6, 9, 12, 21, 24, 27, 2, 1, 5, 4, 17, 16,
         20, 19, 0, 3, 15, 18],
        [8, 7, 11, 10, 26, 25, 29, 28, 6, 9, 24, 27,
         2, 1, 5, 4, 14, 13, 17, 16, 20, 19, 23, 22,
         32, 31, 35, 34, 0, 3, 12, 15, 18, 21, 30, 33],
    ],
]


def parse_pcm_params(r: BitReader) -> tuple[StreamParameters, int, int]:
    """Parse the 9-byte PCM stream-parameter block at the head of each PCM
    packet's pad-2 region (dvda_pcmdecoder_decode_params, pcm.c:79-96).

    Returns (parameters, first_audio_frame, crc)."""
    first_audio_frame, g0bps, g1bps, g0rate, g1rate, chan, crc = r.parse(
        "16u 8p 4u 4u 4u 4u 8p 8u 8p 8u"
    )
    return StreamParameters(g0bps, g1bps, g0rate, g1rate, chan), first_audio_frame, crc


def chunk_size(bits_per_sample: int, channels: int) -> int:
    """Bytes per 2-frame chunk (pcm.c:66-68).  Note 20 // 8 == 2."""
    return (bits_per_sample // 8) * channels * 2


def pcm_gather_indices(bits_per_sample: int, channels: int) -> np.ndarray:
    """Build gather indices mapping chunk bytes → sample byte groups.

    Returns an int32 array ``[2 * channels, 3]`` where entry ``[s, b]`` is
    the chunk-byte index supplying byte ``b`` (little-endian significance:
    0 = LSB) of sample slot ``s``; ``-1`` means the byte is zero (only for
    the 16-bit path's absent third byte and the 20-bit path's unwritten
    ``unswapped`` positions).  Sample slot ``s`` belongs to output channel
    ``s % channels`` and frame ``s // channels`` (pcm.c:159-164).
    """
    bps_index = 0 if bits_per_sample == 16 else 1
    bytes_per_sample = bits_per_sample // 8
    csize = chunk_size(bits_per_sample, channels)
    swap = AOB_BYTE_SWAP[bps_index][channels - 1]
    # invert the scatter: unswapped[swap[i]] = chunk[i]
    max_pos = max(swap[:csize]) + 1
    inv = np.full(max(max_pos, bytes_per_sample * channels * 2 + 1), -1, dtype=np.int32)
    for i in range(csize):
        inv[swap[i]] = i
    group_bytes = 2 if bits_per_sample == 16 else 3
    out = np.full((2 * channels, 3), -1, dtype=np.int32)
    for s in range(2 * channels):
        base = s * bytes_per_sample
        for b in range(group_bytes):
            if base + b < len(inv):
                out[s, b] = inv[base + b]
    return out


def decode_chunks_numpy(chunks: np.ndarray, bits_per_sample: int, channels: int) -> np.ndarray:
    """Vectorised chunk decode (numpy reference for the device kernel).

    ``chunks``: uint8 ``[n, chunk_size]``.  Returns int32 ``[2n, channels]``
    interleaved as frame-major (2 frames per chunk, pcm.c:147-166).
    """
    idx = pcm_gather_indices(bits_per_sample, channels)  # [2ch, 3]
    n = chunks.shape[0]
    # gather with -1 → 0 via a padded zero column
    padded = np.concatenate([chunks, np.zeros((n, 1), dtype=np.uint8)], axis=1)
    g = padded[:, idx]  # [n, 2ch, 3] uint8
    g = g.astype(np.int32)
    if bits_per_sample == 16:
        val = g[..., 0] | (g[..., 1] << 8)
        val = (val ^ 0x8000) - 0x8000  # sign-extend 16
    else:
        val = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16)
        val = (val ^ 0x800000) - 0x800000  # sign-extend 24
    return val.reshape(n * 2, channels)


def payload_to_chunks(payload: bytes, bits_per_sample: int, channels: int) -> np.ndarray:
    """Split one packet's PCM payload into whole chunks, dropping the
    trailing partial chunk (pcm.c:147)."""
    csize = chunk_size(bits_per_sample, channels)
    n = len(payload) // csize
    return np.frombuffer(payload, dtype=np.uint8, count=n * csize).reshape(n, csize)
