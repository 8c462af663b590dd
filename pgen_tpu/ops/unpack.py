"""2-bit genotype unpack: the decode every device analytics scan starts with.

Reference semantics (/root/reference/src/pfile.rs:171-175): each record byte
holds 4 hard calls, LSB-first — sample ``s`` reads byte ``s // 4`` and
extracts ``(byte >> ((s % 4) * 2)) & 0b11``. The reference does this one
sample at a time in scalar Rust; here a whole (variants x record_bytes)
block is decoded at once in plain ``jax.numpy``.

Each input byte produces ONE uint32 word whose 4 little-endian bytes are the
4 codes:

    word_j = sum_k ((x_j >> 2k) & 3) << 8k        (elementwise)

and the (V, R) u32 words are bitcast to (V, 4R) u8, a free row-major
relabeling. Written as plain jnp, XLA fuses the decode into its consumer
(the indicator compare, the dtype cast, the matmul operand), so the codes
are never written to device memory on their own.

Code values: 0=hom-ref(0/0) 1=het(0/1) 2=hom-alt(1/1) 3=missing(./.)
(pfile.rs:177-183).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


# host implementations live in the jax-free unpack_host module (so host
# pipelines can import them without paying the jax import);
# re-exported here for compatibility
from pgen_tpu.ops.unpack_host import (  # noqa: F401
    unpack_codes_numpy,
    unpack_codes_reference,
)


def _unpack_words(x: jnp.ndarray) -> jnp.ndarray:
    """(TV, R) u8 -> (TV, R) u32; word j's bytes (LE) = codes of samples 4j..4j+3.

    Multiply-spread: the even bit-pairs (p0 at bits 0-1, p2 at 4-5) land on
    bytes 0 and 2 via one multiply by (1 | 1<<12) — the shifted copies hit
    disjoint bit ranges, so no carries — and the odd pairs on bytes 1 and 3
    via (1<<6 | 1<<18): 7 integer ops per byte instead of ~11 for the
    shift/and/or ladder. Verified equal to the reference extraction
    (pfile.rs:171-175) for all 256 byte values in tests/test_ops.py.
    """
    xi = x.astype(jnp.uint32)
    even = xi & 0x33
    odd = xi & 0xCC
    return ((even * 0x1001) & 0x00030003) | ((odd * 0x40040) & 0x03000300)


def words_to_bytes(words: jnp.ndarray) -> jnp.ndarray:
    """(V, R) u32 -> (V, 4R) u8, little-endian within each word."""
    v, r = words.shape
    b = jax.lax.bitcast_convert_type(words, jnp.uint8)  # (V, R, 4)
    return b.reshape(v, 4 * r)


def bytes_to_words(b: jnp.ndarray) -> jnp.ndarray:
    """(V, 4R) u8 -> (V, R) u32, inverse of words_to_bytes."""
    v, n = b.shape
    return jax.lax.bitcast_convert_type(b.reshape(v, n // 4, 4), jnp.uint32)


@functools.partial(jax.jit, static_argnames=("num_samples",))
def unpack_codes(packed: jnp.ndarray, num_samples: int):
    """Unpack (V, rec_size) u8 records to (V, num_samples) u8 codes on device."""
    if packed.shape[0] == 0 or packed.shape[1] == 0:
        return jnp.zeros((packed.shape[0], num_samples), dtype=jnp.uint8)
    return words_to_bytes(_unpack_words(packed))[:, :num_samples]
