"""AOB sector reader: one flat 2048-byte-sector address space over the
chained ``ATS_XX_1.AOB`` … ``ATS_XX_9.AOB`` files of a titleset.

Reference analog: src/aob.c (aob_reader_open :90, read :157, seek :181,
tell :201).  Differences in the batched rebuild:

* The reference pulls one 2048-byte sector per fread and decrypts it inline
  (aob.c:157-175).  Batch decode wants bulk I/O, so the primary interface
  here is :meth:`read_sectors` — a vectorised numpy read of N sectors at
  once (memory-mapped), with CPPM decryption applied to the whole batch.
  The scalar :meth:`read` / :meth:`seek` / :meth:`tell` pull API is kept for
  the streaming façade and matches the reference semantics (including
  falling through to the next AOB file on a short read).
* Decryption is a pluggable callable ``decrypt(sectors) -> sectors`` (see
  dvda.cppm.decrypt) instead of an ``#ifdef HAS_CPPM`` compile flag
  (aob.c:43-46,127-142).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .audio_ts import find_audio_ts_file

__all__ = ["SECTOR_SIZE", "AOBReader"]

SECTOR_SIZE = 2048


class AOBReader:
    """Reader over the concatenated sector space of a titleset's AOB files."""

    def __init__(
        self,
        audio_ts_path: str | os.PathLike,
        titleset: int,
        decrypt: Callable[[np.ndarray], np.ndarray] | None = None,
    ):
        self._maps: list[np.ndarray] = []
        self._sector_counts: list[int] = []
        # Chain AOB files 1..9 until one is missing (aob.c:101-123).
        for aob_number in range(1, 10):
            path = find_audio_ts_file(audio_ts_path, f"ATS_{titleset:02d}_{aob_number:d}.AOB")
            if path is None:
                break
            try:
                size = os.path.getsize(path)
                total = size // SECTOR_SIZE
                m = np.memmap(path, dtype=np.uint8, mode="r", shape=(total, SECTOR_SIZE))
            except (OSError, ValueError):
                break
            self._maps.append(m)
            self._sector_counts.append(total)
        self._offsets = np.cumsum([0] + self._sector_counts)  # len = n_files + 1
        self._pos = 0  # current sector in the flat space
        self._decrypt = decrypt

    @property
    def total_sectors(self) -> int:
        return int(self._offsets[-1]) if len(self._offsets) else 0

    # -- bulk interface (batch planner) ------------------------------------

    def read_sectors(self, first: int, count: int) -> np.ndarray:
        """Read ``count`` sectors starting at flat sector ``first``.

        Returns a ``(n, 2048) uint8`` array; ``n`` may be short at the end
        of the sector space.  Decryption (if configured) is applied to the
        whole batch.
        """
        first = max(0, first)
        count = max(0, min(count, self.total_sectors - first))
        if count == 0:
            return np.empty((0, SECTOR_SIZE), dtype=np.uint8)
        parts = []
        need = count
        pos = first
        for i, m in enumerate(self._maps):
            lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
            if pos >= hi or need == 0:
                continue
            if pos < lo:
                break
            take = min(hi - pos, need)
            parts.append(np.asarray(m[pos - lo : pos - lo + take]))
            pos += take
            need -= take
        out = parts[0].copy() if len(parts) == 1 else np.concatenate(parts, axis=0)
        if self._decrypt is not None:
            out = self._decrypt(out)
        return out

    # -- scalar pull interface (streaming façade) ---------------------------

    def seek(self, sector_number: int) -> bool:
        """Seek to a flat sector; returns False past the end (aob.c:181-199)."""
        if sector_number >= self.total_sectors:
            return False
        self._pos = sector_number
        return True

    def tell(self) -> int:
        return self._pos

    def read(self) -> np.ndarray | None:
        """Read the sector at the cursor, or ``None`` at end of space."""
        if self._pos >= self.total_sectors:
            return None
        out = self.read_sectors(self._pos, 1)
        self._pos += 1
        return out[0]

    def close(self) -> None:
        self._maps.clear()
