"""2-bit genotype pack: device twin of the unpack decode.

Packs a (V, S) u8 code matrix (values 0..3) into mode-0x02 records of
ceil(2S/8) bytes, LSB-first within each byte — the inverse of
unpack.unpack_codes and the device-side counterpart of
formats/writer.pack_codes. Enables on-device .pgen re-emission (pgen output
is "future work" in the reference, /root/reference/README.md:217-219).

The code matrix is bitcast to (V, R) u32 words — 4 consecutive sample codes
per little-endian word — and each word reduces to its record byte
elementwise:

    byte_j = sum_k ((w_j >> 8k) & 3) << 2k
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pgen_tpu.ops.unpack import bytes_to_words


@jax.jit
def pack_codes_device(codes: jnp.ndarray):
    """Pack (V, S) u8 codes into (V, ceil(S/4)) record bytes on device."""
    nsamp = codes.shape[1]
    rec = (nsamp + 3) // 4
    if nsamp != 4 * rec:
        codes = jnp.pad(codes, ((0, 0), (0, 4 * rec - nsamp)))
    w = bytes_to_words(codes)  # (V, rec) u32
    b = w & 0x3
    b |= ((w >> 8) & 0x3) << 2
    b |= ((w >> 16) & 0x3) << 4
    b |= ((w >> 24) & 0x3) << 6
    return b.astype(jnp.uint8)
