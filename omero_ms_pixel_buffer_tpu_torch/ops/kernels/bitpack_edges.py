"""Token arrays at the scalar-prefetch kernel's edges (``csrc/bitpack.cu``):
one list of geometries, made from a seed with numpy, that the tests and
``chip_smoke.py`` both hold the kernel and its plain version to.

The kernel packs tiles of ``SP_TILE`` tokens that start on 16-byte
boundaries of the flat (B, ntok) arrays (odd ntok misaligns the rows),
hands a tile's partial last word to its successors, and lets the lane's
last tile write the zero tail; the geometries below reach each of those.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from .bitpack import SP_TILE

Tokens = Tuple[np.ndarray, np.ndarray]


def random_tokens(rng: np.random.Generator, lanes: int, ntok: int, max_bits: int = 21,
                  one_bit_lane: bool = False) -> Tokens:
    """Random valid (bits, nbits) int32 tokens: bit counts in
    [0, max_bits] (zeros included), values below 2^nbits (20 significant
    bits at most)."""
    nbits = rng.integers(0, max_bits + 1, (lanes, ntok)).astype(np.int32)
    nbits[:, :: 7] = 0  # zero-length tokens (run interiors, padding)
    nbits[:, 1:2] = max_bits  # a full-width token in every lane (of two or more)
    if one_bit_lane:
        nbits[-1] = 1
    vals = rng.integers(0, 1 << 20, (lanes, ntok)).astype(np.int64)
    vals &= (1 << np.minimum(nbits, 20)) - 1
    return vals.astype(np.int32), nbits


def padded_maxbits(nbits: np.ndarray) -> int:
    """A maxbits above every lane's total: its 1024-bit round-up plus 1024."""
    return int(-(-int(nbits.sum(axis=1).max()) // 1024) * 1024 + 1024)


def _short_tiles(rng) -> Tokens:
    """Tiles whose bits stay under 32: a 3-bit token every 1,500, so a tile
    holds 2 or 3 of them and most tiles never cross a word boundary."""
    ntok = 5 * SP_TILE + 7
    nbits = np.zeros((2, ntok), np.int32)
    nbits[:, ::1500] = 3
    return rng.integers(0, 8, nbits.shape).astype(np.int32) & ((1 << nbits) - 1), nbits


def _all_21_bits(rng) -> Tokens:
    nbits = np.full((2, 2 * SP_TILE + 3), 21, np.int32)
    return rng.integers(0, 1 << 21, nbits.shape).astype(np.int32), nbits


def _single_token(lanes: int) -> Callable[[np.random.Generator], Tokens]:
    def make(rng):
        nbits = rng.integers(1, 22, (lanes, 1)).astype(np.int32)
        return rng.integers(0, 1 << 21, (lanes, 1)).astype(np.int32) & ((1 << nbits) - 1), nbits

    return make


def _zero_lane(rng) -> Tokens:
    bits, nbits = random_tokens(rng, 3, 1000)
    bits[1], nbits[1] = 0, 0
    return bits, nbits


# name: (tokens(rng), maxbits(nbits))
SP_EDGES: Dict[str, Tuple[Callable[[np.random.Generator], Tokens],
                          Callable[[np.ndarray], int]]] = {
    "zero_lane_between": (_zero_lane, padded_maxbits),
    "single_token": (_single_token(1), padded_maxbits),
    "single_token_3_lanes": (_single_token(3), padded_maxbits),
    "ntok_tile_minus_1": (lambda rng: random_tokens(rng, 3, SP_TILE - 1), padded_maxbits),
    "ntok_tile": (lambda rng: random_tokens(rng, 3, SP_TILE), padded_maxbits),
    "ntok_tile_plus_1": (lambda rng: random_tokens(rng, 3, SP_TILE + 1), padded_maxbits),
    "ntok_2tile_plus_1": (lambda rng: random_tokens(rng, 3, 2 * SP_TILE + 1), padded_maxbits),
    "odd_ntok_misaligned_rows": (lambda rng: random_tokens(rng, 4, 5003), padded_maxbits),
    "tiles_under_32_bits": (_short_tiles, padded_maxbits),
    "all_21_bits": (_all_21_bits, padded_maxbits),
    # truncation inside a tile, and a long zero tail
    "maxbits_mid_tile": (lambda rng: random_tokens(rng, 2, 3 * SP_TILE),
                         lambda nbits: 32 * 1000),
    "maxbits_far_above": (lambda rng: random_tokens(rng, 2, 3000),
                          lambda nbits: padded_maxbits(nbits) + 200 * 1024),
}


def sp_edge_case(name: str, seed: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """The edge geometry ``name`` made from ``seed``: (bits, nbits, maxbits)."""
    make, maxbits = SP_EDGES[name]
    bits, nbits = make(np.random.default_rng(seed))
    return bits, nbits, maxbits(nbits)
