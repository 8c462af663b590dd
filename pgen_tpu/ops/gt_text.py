"""Genotype text emission: codes -> VCF GT column bytes, on device.

The reference formats genotypes one sample at a time with a scalar match and
two BufWriter.write calls per sample (/root/reference/src/pfile.rs:171-188),
which makes VCF text assembly its real bottleneck (SURVEY.md §6: the keep-all
chr22 filter spends 18.9 s of sys time writing). Here the whole GT region of
a variant block is produced as one device byte tensor:

    sample s contributes 4 output bytes [\t, b0, /, b1] at columns 4s..4s+3
      code 0 -> \t0/0   code 1 -> \t0/1   code 2 -> \t1/1   code 3 -> \t./.

Each code becomes ONE uint32 word ``TAB | b0<<8 | SLASH<<16 | b1<<24`` —
elementwise, no lookup table, since b0/b1 are 2-way selects on the code —
and the word array is bitcast to bytes. The fused packed->text path composes
the unpack words (see unpack.py) with this one in a single XLA fusion.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pgen_tpu.ops.unpack import _unpack_words, words_to_bytes

_TAB = ord("\t")
_SLASH = ord("/")
_ZERO = ord("0")
_ONE = ord("1")
_DOT = ord(".")


def _text_word(c: jnp.ndarray) -> jnp.ndarray:
    """code (u32, values 0..3) -> u32 word of the 4 text bytes (LE)."""
    b0 = jnp.where(c < 2, _ZERO, jnp.where(c == 2, _ONE, _DOT)).astype(jnp.uint32)
    b1 = jnp.where(c == 0, _ZERO, jnp.where(c == 3, _DOT, _ONE)).astype(jnp.uint32)
    return _TAB | (b0 << 8) | (_SLASH << 16) | (b1 << 24)


@jax.jit
def genotype_text_from_codes(codes: jnp.ndarray):
    """(V, S) u8 codes -> (V, 4S) u8 VCF text ("\\t" + 3-byte token per call)."""
    nvar, nsamp = codes.shape
    if nvar == 0 or nsamp == 0:
        return jnp.zeros((nvar, 4 * nsamp), dtype=jnp.uint8)
    return words_to_bytes(_text_word(codes.astype(jnp.uint32)))


@functools.partial(jax.jit, static_argnames=("num_samples",))
def genotype_text(packed: jnp.ndarray, num_samples: int):
    """Fused packed-records -> VCF GT text.

    (V, rec_size) u8 -> (V, 4*num_samples) u8: unpack words, bitcast to the
    code matrix, text words, bitcast to bytes. The filter itself uses the
    plane form below.
    """
    if packed.shape[0] == 0 or num_samples == 0:
        return jnp.zeros((packed.shape[0], 4 * num_samples), dtype=jnp.uint8)
    codes = words_to_bytes(_unpack_words(packed))
    return genotype_text_from_codes(codes)[:, : 4 * num_samples]


def planes_from_packed(packed: jnp.ndarray):
    """Plane-form text: four (V, R) u32 planes, plane k lane j = text word
    of sample 4j+k, elementwise from the packed byte (no unpack bitcast,
    no interleave); the host assembler interleaves (native
    assemble_rows_planes / interleave_planes). This is THE
    plane-k/sample-4j+k contract — every producer and consumer goes
    through here or the two assemblers."""
    xi = packed.astype(jnp.uint32)
    return tuple(_text_word((xi >> (2 * k)) & 3) for k in range(4))


genotype_text_planes = jax.jit(planes_from_packed)


def interleave_planes_numpy(planes, gt_len: int) -> np.ndarray:
    """Host fallback for the native plane assembler: (V, W) u32 x4 ->
    (V, gt_len) u8 interleaved text (sample s's word = planes[s%4][s//4])."""
    inter = np.stack([np.asarray(p) for p in planes], axis=2)  # (V, W, 4)
    return inter.view(np.uint8).reshape(inter.shape[0], -1)[:, :gt_len]


@jax.jit
def _subset_words(packed: jnp.ndarray, byte_idx, shift) -> jnp.ndarray:
    """Kept-sample text words straight from the packed bytes: (V, K) u32.

    byte_idx = sel//4 (record byte of each kept sample), shift = 2*(sel%4).
    Only the gathered byte columns are read and only K words/variant are
    materialized, so the d2h transfer behind the host's np.asarray is
    4*K B/variant instead of the full-width plane set (16 B per record
    byte) — subset queries' device traffic scales with the subset."""
    xi = packed[:, byte_idx].astype(jnp.uint32)
    return _text_word((xi >> shift) & 3)


def subset_text_from_packed(packed: jnp.ndarray, sel) -> np.ndarray:
    """(V, rec) device bytes + kept sample ids -> (V, 4*len(sel)) u8 host
    text in kept-sample order (the subset twin of the plane path)."""
    sel = np.asarray(sel, dtype=np.int64)
    n_var = packed.shape[0]
    if len(sel) == 0 or n_var == 0:
        return np.zeros((n_var, 4 * len(sel)), dtype=np.uint8)
    words = np.asarray(
        _subset_words(packed, sel // 4, (2 * (sel % 4)).astype(np.uint32))
    )
    return words.view(np.uint8).reshape(n_var, -1)


def genotype_text_reference(codes: np.ndarray) -> np.ndarray:
    """Numpy oracle: codes (V,S) -> text (V,4S) via an explicit token table."""
    table = np.frombuffer(b"\t0/0\t0/1\t1/1\t./.", dtype=np.uint8).reshape(4, 4)
    return table[np.asarray(codes)].reshape(codes.shape[0], -1)
