"""Banded linkage-disequilibrium r² and window-greedy pruning.

The plink `--indep-pairwise <window>[kb] <step> <r2>` analog (extension —
the reference has no genotype analysis at all). Two pieces:

1. **Banded r² precompute** (the compute-heavy part, matmul-shaped):
   r²(i, j) for all variant pairs with index distance < band, as a dense
   (V, band) matrix where column d holds r²(i, i+1+d). Correlation uses
   mean-imputed centered dosages — c_vs = (g_vs - 2 p_v) for called
   entries, 0 (the mean) for missing — so

       r(i, j) = <c_i, c_j> / (||c_i|| ||c_j||)

   and any per-variant scaling cancels. The band is computed as tiled
   Grams: row tile t (band rows) against the (band x 2band) slice
   starting at the same row — ONE gemm per tile covers every in-band
   pair, 4*V*band*S MACs total. Device provider batches the tile gemms
   into one einsum; host uses per-tile BLAS sgemm with f64 norms.

2. **Window-greedy prune** (host, sequential by definition): plink's
   window/step walk over the precomputed band. For each window start s
   (s = 0, step, 2*step, ...), candidate pairs are the in-band pairs
   (i, j) with s <= i < j < s+window whose r² exceeds the threshold,
   visited in lexicographic order; if both are still alive, the one
   with the LOWER MAF is removed (tie: the later variant). Removal
   never changes other pairs' r², so precomputed values stay valid.
   Monomorphic variants (zero variance) have undefined r; they are
   never pruned (r treated as 0), matching their zero-information role.

Exactness note: published --indep-pairwise implementations differ in
missing-data handling and tie-breaks; this module's spec is the one
documented above, pinned by a brute-force oracle in tests/test_ld.py.
"""

from __future__ import annotations

import numpy as np


def centered_dosage_np(codes: np.ndarray):
    """(W, S) u8 codes -> (c, norm): mean-imputed centered dosage rows
    (f64) and their L2 norms. Missing entries sit at the mean (0)."""
    called = codes != 3
    g = codes.astype(np.float64) * called
    n_called = called.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p2 = np.where(n_called > 0, g.sum(axis=1) / np.maximum(n_called, 1), 0.0)
    c = (g - p2[:, None]) * called
    return c, np.sqrt((c * c).sum(axis=1))


def banded_r2_reference(codes: np.ndarray, band: int) -> np.ndarray:
    """Brute-force oracle: (V, band) with [i, d] = r²(i, i+1+d)."""
    nvar = codes.shape[0]
    c, norm = centered_dosage_np(codes)
    out = np.zeros((nvar, band), dtype=np.float64)
    for i in range(nvar):
        for d in range(band):
            j = i + 1 + d
            if j >= nvar:
                break
            den = norm[i] * norm[j]
            if den > 0:
                out[i, d] = (c[i] @ c[j]) ** 2 / (den * den)
    return out


def banded_r2_numpy(
    packed: np.ndarray, num_samples: int, band: int, sample_idx=None
) -> np.ndarray:
    """Tiled-gemm band: tile rows x their 2*band-row slice, f64."""
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    out = np.zeros((nvar, band), dtype=np.float64)
    if nvar == 0 or band == 0:
        return out
    # one standardize pass per tile slice would recompute rows band/band
    # times; rows are cheap vs the gemm, so recompute per slice for
    # simplicity and O(band) working memory
    for t0 in range(0, nvar, band):
        hi = min(t0 + 2 * band, nvar)
        codes = unpack_codes_numpy(packed[t0:hi], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        c, norm = centered_dosage_np(codes)
        w = min(band, nvar - t0)
        gram = c[:w] @ c.T  # (w, hi-t0)
        den = norm[:w, None] * norm[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = np.where(den > 0, (gram / np.maximum(den, 1e-300)) ** 2, 0.0)
        out[t0 : t0 + w] = _take_band(r2, band)
    return out


def _take_band(r2: np.ndarray, band: int) -> np.ndarray:
    """(w, L) pairwise matrix -> (w, band) with [i, d] = r2[i, i+1+d]
    (0 past the matrix edge) — one fancy-index diagonal gather."""
    w, L = r2.shape
    cols = np.arange(w)[:, None] + 1 + np.arange(band)[None, :]
    valid = cols < L
    return np.where(valid, r2[np.arange(w)[:, None], np.minimum(cols, L - 1)], 0.0)


def banded_r2_device(
    packed, num_samples: int, band: int, sample_idx=None
) -> np.ndarray:
    """Batched tile Grams in f32 matmuls: one einsum over all tiles.

    Tiles are (band x S) against (2band x S); variants pad to a tile
    multiple with 0xFF (all-missing -> zero rows, r² = 0).
    """
    import jax
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    if nvar == 0 or band == 0:
        return np.zeros((nvar, band), dtype=np.float64)
    ntile = -(-nvar // band)
    pad_rows = (ntile + 1) * band - nvar  # one extra tile of tail context
    padded = np.pad(packed, ((0, pad_rows), (0, 0)), constant_values=0xFF)

    @jax.jit
    def _tiles(pk):
        codes = unpack_codes(pk, num_samples)
        if sample_idx is not None:
            codes = jnp.take(codes, jnp.asarray(sample_idx), axis=1)
        called = codes != 3
        g = codes.astype(jnp.float32) * called
        n_called = jnp.sum(called, axis=1).astype(jnp.float32)
        p2 = jnp.where(n_called > 0, jnp.sum(g, axis=1) / jnp.maximum(n_called, 1.0), 0.0)
        c = (g - p2[:, None]) * called
        norm2 = jnp.sum(c * c, axis=1)
        ns = c.shape[1]
        full = c.reshape(ntile + 1, band, ns)
        a = full[:-1]  # (ntile, band, ns)
        # slice t covers rows [t*band, t*band + 2*band) = tiles t, t+1
        b = jnp.concatenate([full[:-1], full[1:]], axis=1)  # (ntile, 2band, ns)
        gram = jnp.einsum(
            "twc,tvc->twv", a, b,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return gram, norm2

    gram, norm2 = (np.asarray(x, dtype=np.float64) for x in _tiles(padded))
    norm = np.sqrt(norm2)
    out = np.zeros((nvar, band), dtype=np.float64)
    for t in range(ntile):
        w = min(band, nvar - t * band)
        rows = t * band + np.arange(w)
        den = norm[rows][:, None] * norm[t * band : t * band + 2 * band][None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = np.where(den > 0, (gram[t, :w] / np.maximum(den, 1e-300)) ** 2, 0.0)
        # zero past-the-end pairs (pad rows are all-missing -> r2 0 anyway)
        band_vals = _take_band(r2, band)
        past = rows[:, None] + 1 + np.arange(band)[None, :] >= nvar
        out[rows] = np.where(past, 0.0, band_vals)
    return out


def banded_r2(
    packed, num_samples: int, band: int, provider: str = "numpy", sample_idx=None
) -> np.ndarray:
    if provider == "device":
        from pgen_tpu.pipeline.device import device_backend

        device_backend()
        return banded_r2_device(packed, num_samples, band, sample_idx)
    return banded_r2_numpy(packed, num_samples, band, sample_idx=sample_idx)


def greedy_prune(
    r2_band: np.ndarray,
    maf: np.ndarray,
    window_counts: np.ndarray,
    step: int,
    threshold: float,
) -> np.ndarray:
    """The window/step greedy walk; returns the alive bool mask.

    window_counts[i] = window extent (in variants) when the window starts
    at i — a constant array for count windows, position-derived for kb
    windows. Pairs beyond the precomputed band are never candidates
    (callers size the band to the max window extent).
    """
    nvar, band = r2_band.shape
    alive = np.ones(nvar, dtype=bool)
    if nvar == 0:
        return alive
    # sparse exceed-pairs, lexicographic by construction
    ii, dd = np.nonzero(r2_band > threshold)
    jj = ii + 1 + dd
    for s in range(0, nvar, max(step, 1)):
        e = min(s + int(window_counts[s]), nvar)
        lo, hi = np.searchsorted(ii, (s, e))
        for k in range(lo, hi):
            i, j = ii[k], jj[k]
            if j >= e or not (alive[i] and alive[j]):
                continue
            # remove the lower-MAF member; tie removes the later variant
            victim = i if maf[i] < maf[j] else j
            alive[victim] = False
        if e >= nvar:
            break
    return alive
