"""MLP residual Huffman codebooks and the codebook → LUT compiler.

Reference analogs: the three canonical codebook definitions
src/mlp_codebook{1,2,3}.json and the build-time compiler that turns them
into reader-state jump tables (src/huffman.c:262-418, Makefile:108-115).

The reference compiles codebooks into 0x200-entry tables keyed by its bit
reader's 9-bit state machine.  The rebuild's decoders are not state
machines, so the compiler here emits two vector-friendly forms instead:

* a **flat peek LUT**: all codes are ≤ 9 bits, so a 512-entry table keyed
  by the next 9 bits of the stream gives ``(value, code_length)`` in one
  lookup — used by the vectorised/native residual decoders;
* a **binary tree** for the bit-by-bit Python reference reader
  (BitReader.read_huffman_code).

An **encode map** (value → (code, length)) is also produced for the MLP
stream synthesiser (tests need an encoder-for-tests; SURVEY §4).

Codebook shapes (values are the residual MSBs, mlp.c:1211-1227):
  codebook 1: values 0..17, codes 3..9 bits  (escape/invalid: two 9-bit codes)
  codebook 2: values 0..15, codes 2..9 bits
  codebook 3: values 0..14, codes 1..9 bits
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "CODEBOOKS",
    "MAX_CODE_LEN",
    "peek_lut",
    "decode_tree",
    "encode_map",
    "codebook_value_range",
    "compile_entries",
    "load_codebook_json",
    "build_codebook",
]

MAX_CODE_LEN = 9

# (code bits as a string, value); value None = invalid/escape code.
# Data from src/mlp_codebook{1,2,3}.json — canonical MLP tables.
CODEBOOKS: dict[int, list[tuple[str, int | None]]] = {
    1: [
        ("111", 10), ("110", 9), ("101", 8), ("100", 7), ("011", 11),
        ("0101", 12), ("01001", 13), ("010001", 14), ("0100001", 15),
        ("01000001", 16), ("010000001", 17), ("010000000", None),
        ("001", 6), ("0001", 5), ("00001", 4), ("000001", 3),
        ("0000001", 2), ("00000001", 1), ("000000001", 0),
        ("000000000", None),
    ],
    2: [
        ("11", 8), ("10", 7), ("011", 9), ("0101", 10), ("01001", 11),
        ("010001", 12), ("0100001", 13), ("01000001", 14), ("010000001", 15),
        ("010000000", None),
        ("001", 6), ("0001", 5), ("00001", 4), ("000001", 3),
        ("0000001", 2), ("00000001", 1), ("000000001", 0),
        ("000000000", None),
    ],
    3: [
        ("1", 7), ("011", 8), ("0101", 9), ("01001", 10), ("010001", 11),
        ("0100001", 12), ("01000001", 13), ("010000001", 14),
        ("010000000", None),
        ("001", 6), ("0001", 5), ("00001", 4), ("000001", 3),
        ("0000001", 2), ("00000001", 1), ("000000001", 0),
        ("000000000", None),
    ],
}


def compile_entries(entries, max_len: int | None = None):
    """Generic codebook compiler: ``entries`` is a list of
    (code-bit-string, value-or-None); returns flat peek tables
    ``(values, lengths)`` of size 2^max_len.

    This is the rebuild's analog of the reference's runtime Huffman
    compiler (compile_br_huffman_table, huffman.h:84): any prefix-free
    codebook — not just the three MLP ones — compiles to gather-friendly
    tables.  Raises ValueError on duplicate/overlapping codes.
    """
    if max_len is None:
        max_len = max(len(c) for c, _ in entries)
    values = np.full(1 << max_len, -1, dtype=np.int32)
    lengths = np.zeros(1 << max_len, dtype=np.int32)
    for code, value in entries:
        n = len(code)
        if n > max_len:
            raise ValueError(f"code {code} longer than max_len {max_len}")
        prefix = int(code, 2) << (max_len - n)
        span = 1 << (max_len - n)
        if value is None:
            continue
        if lengths[prefix : prefix + span].any():
            raise ValueError(f"code {code} overlaps an earlier code")
        values[prefix : prefix + span] = value
        lengths[prefix : prefix + span] = n
    return values, lengths


def build_codebook(frequencies) -> list[tuple[str, int]]:
    """Build a canonical prefix-free codebook from value frequencies.

    Reference analog: the runtime frequency-list entry point of the
    Huffman compiler (compile_huffman_tree, huffman.c:262-353, which
    accepts ``(value, frequency)`` pairs as well as JSON codebooks).

    ``frequencies`` is a mapping or iterable of ``(value, count)``; the
    result is (code-string, value) entries — canonical Huffman codes,
    shortest codes to the most frequent values, ties broken by value —
    directly consumable by :func:`compile_entries`.
    """
    import heapq
    from itertools import count

    items = (list(frequencies.items()) if hasattr(frequencies, "items")
             else list(frequencies))
    if not items:
        return []
    if len(items) == 1:
        return [("0", items[0][0])]
    tick = count()  # tie-breaker so heap entries never compare values
    heap = [(freq, next(tick), [value]) for value, freq in items]
    depth = {value: 0 for value, _ in items}
    heapq.heapify(heap)
    while len(heap) > 1:
        fa, _, va = heapq.heappop(heap)
        fb, _, vb = heapq.heappop(heap)
        for v in va + vb:
            depth[v] += 1
        heapq.heappush(heap, (fa + fb, next(tick), va + vb))
    # canonical code assignment: by (length, value)
    order = sorted(depth, key=lambda v: (depth[v], v))
    entries = []
    code = 0
    prev_len = depth[order[0]]
    for v in order:
        code <<= depth[v] - prev_len
        prev_len = depth[v]
        entries.append((format(code, f"0{depth[v]}b"), v))
        code += 1
    return entries


def load_codebook_json(path: str):
    """Load a codebook in the reference's JSON layout — a flat list
    alternating bit arrays and values (src/mlp_codebookN.json; negative
    values mark invalid codes) — into (code-string, value) entries."""
    import json

    with open(path) as f:
        flat = json.load(f)
    entries = []
    for i in range(0, len(flat), 2):
        bits, value = flat[i], flat[i + 1]
        code = "".join(str(b) for b in bits)
        entries.append((code, None if value < 0 else int(value)))
    return entries


@lru_cache(maxsize=None)
def peek_lut(codebook: int) -> tuple[np.ndarray, np.ndarray]:
    """Compile a canonical MLP codebook to flat 9-bit peek tables.

    Returns ``(values, lengths)``, both int32[512]: index with the next 9
    bits (MSB-first); ``lengths[i]`` is the code length to consume and
    ``values[i]`` the decoded MSB, or length 0 / value -1 for invalid
    codes (the reference signals these as -1, mlp.c:1228-1229).
    """
    return compile_entries(CODEBOOKS[codebook], MAX_CODE_LEN)


@lru_cache(maxsize=None)
def decode_tree(codebook: int):
    """Compile a codebook to a nested-tuple binary tree for the Python
    bit reader.  Nodes are [zero, one] pairs; leaves are values or None."""

    def insert(node: list, code: str, value):
        bit = int(code[0])
        if len(code) == 1:
            node[bit] = value
        else:
            if not isinstance(node[bit], list):
                node[bit] = [None, None]
            insert(node[bit], code[1:], value)

    root: list = [None, None]
    for code, value in CODEBOOKS[codebook]:
        insert(root, code, value)

    def freeze(node):
        if isinstance(node, list):
            return (freeze(node[0]), freeze(node[1]))
        return node

    return freeze(root)


@lru_cache(maxsize=None)
def encode_map(codebook: int) -> dict[int, tuple[int, int]]:
    """value → (code_bits, code_length), for the test-stream synthesiser."""
    out = {}
    for code, value in CODEBOOKS[codebook]:
        if value is not None:
            out[value] = (int(code, 2), len(code))
    return out


def codebook_value_range(codebook: int) -> tuple[int, int]:
    """Inclusive (min, max) encodable MSB for a codebook."""
    vals = [v for _, v in CODEBOOKS[codebook] if v is not None]
    return min(vals), max(vals)
