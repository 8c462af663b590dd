"""Polygenic scoring: genotype-matrix x weight-matrix products (matmul workload).

The plink2 `--score` analog (extension — the reference is a query/filter
tool, /root/reference/README.md:3-5). Given per-variant effect weights
w_vk (K score columns) on an effect allele, each sample's score sum is

    sum_k[s] = sum_v  d_vs * w_vk

where d_vs is the effect-allele dosage in {0, 1, 2}: the alt-allele count
when the effect allele is ALT, and 2 - count when it is REF ("flipped"
rows). Missing hard calls are mean-imputed by default (d -> the variant's
mean dosage over called samples, plink2's default) or contribute 0 with
`mean_impute=False` (plink2 `no-mean-imputation`), in which case the
per-sample denominator shrinks accordingly.

The whole computation is one (V, S)^T @ (V, K) matmul per variant block —
matmul work on the device provider (f32 accumulation, Precision.HIGHEST:
real-valued weights need true-f32 passes, same reasoning as ops/pca.py),
blocked BLAS dgemm on host. Side outputs ride the same pass: per-sample
effect-allele dosage sums and the allele-count denominators.

Denominator semantics (documented, deterministic):
  - ALLELE_CT[s] = 2 * #variants whose dosage entered sample s's sum:
    with mean imputation every variant with >= 1 called sample counts for
    every sample; without, only variants where s itself is called count.
  - Variants with zero called samples contribute nothing and are never
    counted (their mean dosage is undefined).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np


class ScoreResult(NamedTuple):
    sums: np.ndarray  # (S, K) f64 score sums
    dosage_sum: np.ndarray  # (S,) f64 effect-allele dosage sums
    allele_ct: np.ndarray  # (S,) i64 per-sample denominators
    m_used: int  # variants with >= 1 called sample


def score_numpy(
    packed: np.ndarray,
    num_samples: int,
    weights: np.ndarray,
    flip: np.ndarray,
    mean_impute: bool = True,
    block_variants: int = 1024,
    sample_idx=None,
) -> ScoreResult:
    """Host provider: f64 dosage + dgemm per block, in-place block buffers
    (fresh temporaries pay the first-touch tax — see ROADMAP.md Host IO).

    Block default 1024: cache-resident (bv, S) f64 buffers for the
    elementwise dosage passes — the old 1<<13 streamed 165 MB through
    DRAM every pass, measured 2x slower (25k vs 51k var/s, r5; same
    cliff as ops/glm.py's moment providers)."""
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    weights = np.asarray(weights, dtype=np.float64)
    flip = np.asarray(flip, dtype=bool)
    nvar = packed.shape[0]
    if weights.ndim != 2 or weights.shape[0] != nvar or flip.shape != (nvar,):
        raise ValueError(
            f"score: weights {weights.shape} / flip {flip.shape} do not "
            f"match {nvar} variants"
        )
    ns = num_samples if sample_idx is None else len(sample_idx)
    k = weights.shape[1]
    sums = np.zeros((ns, k), dtype=np.float64)
    dosage = np.zeros(ns, dtype=np.float64)
    ct = np.zeros(ns, dtype=np.int64)
    m_used = 0
    bv = min(block_variants, max(nvar, 1))
    d = np.empty((bv, ns), dtype=np.float64)
    called = np.empty((bv, ns), dtype=bool)
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        n = codes.shape[0]
        db, cal = d[:n], called[:n]
        np.not_equal(codes, 3, out=cal)
        np.copyto(db, codes, casting="unsafe")
        db *= cal  # alt-dosage, missing -> 0
        fb = flip[lo : lo + n]
        db[fb] = 2.0 * cal[fb] - db[fb]  # effect allele is REF
        n_called = cal.sum(axis=1)
        used = n_called > 0
        m_used += int(used.sum())
        if mean_impute:
            mean = db.sum(axis=1) / np.maximum(n_called, 1)
            db += np.where(used, mean, 0.0)[:, None] * ~cal
            ct += 2 * int(used.sum())
        else:
            ct += 2 * (cal & used[:, None]).sum(axis=0)
        sums += db.T @ weights[lo : lo + n]
        dosage += db.sum(axis=0)
    return ScoreResult(sums, dosage, ct, m_used)


@functools.partial(
    jax.jit, static_argnames=("num_samples", "mean_impute", "block_variants")
)
def _score_device_jit(
    packed, weights, flip, sel, num_samples, mean_impute, block_variants,
):
    """Blocked scan: unpack -> effect dosage -> f32 matmul accumulate.

    Pad rows must be 0xFF (all-missing, flip False, weight 0): they carry
    zero dosage and are excluded from every count by the used gate.
    """
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes  # noqa: F401 (used in body)

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)
    weights = jnp.pad(weights.astype(jnp.float32), ((0, pad), (0, 0)))
    flip = jnp.pad(flip, (0, pad))
    ns = num_samples if sel is None else sel.shape[0]
    k = weights.shape[1]

    def body(carry, blk):
        sums, dosage, ct, m = carry
        pk, wb, fb = blk
        codes = unpack_codes(pk, num_samples)
        if sel is not None:
            codes = jnp.take(codes, sel, axis=1)
        cal = codes != 3
        g = codes.astype(jnp.float32) * cal
        db = jnp.where(fb[:, None], 2.0 * cal - g, g)
        n_called = jnp.sum(cal, axis=1)
        used = n_called > 0
        if mean_impute:
            mean = jnp.sum(db, axis=1) / jnp.maximum(n_called, 1)
            db = db + jnp.where(used, mean, 0.0)[:, None] * ~cal
            ct = ct + 2 * jnp.sum(used.astype(jnp.int32))
        else:
            ct = ct + 2 * jnp.sum(
                (cal & used[:, None]).astype(jnp.int32), axis=0
            )
        sums = sums + jnp.matmul(
            db.T, wb,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        dosage = dosage + jnp.sum(db, axis=0)
        return (sums, dosage, ct, m + jnp.sum(used.astype(jnp.int32))), None

    init = (
        jnp.zeros((ns, k), dtype=jnp.float32),
        jnp.zeros((ns,), dtype=jnp.float32),
        (jnp.zeros((), jnp.int32) if mean_impute
         else jnp.zeros((ns,), jnp.int32)),
        jnp.zeros((), jnp.int32),
    )
    blocks = (
        packed.reshape(nblk, block_variants, packed.shape[1]),
        weights.reshape(nblk, block_variants, k),
        flip.reshape(nblk, block_variants),
    )
    (sums, dosage, ct, m), _ = jax.lax.scan(body, init, blocks)
    return sums, dosage, ct, m


def score_device(
    packed,
    num_samples: int,
    weights,
    flip,
    mean_impute: bool = True,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> ScoreResult:
    ns = num_samples if sample_idx is None else len(sample_idx)
    weights = np.asarray(weights, dtype=np.float32)
    if packed.shape[0] == 0:
        return ScoreResult(
            np.zeros((ns, weights.shape[1])), np.zeros(ns),
            np.zeros(ns, np.int64), 0,
        )
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)
    sums, dosage, ct, m = _score_device_jit(
        np.asarray(packed, np.uint8), weights, np.asarray(flip, bool), sel,
        num_samples, mean_impute, block_variants,
    )
    ct = np.asarray(ct, np.int64)
    if ct.ndim == 0:  # mean-impute path counts one scalar for all samples
        ct = np.full(ns, int(ct), dtype=np.int64)
    return ScoreResult(
        np.asarray(sums, np.float64), np.asarray(dosage, np.float64),
        ct, int(m),
    )


def score_native(
    packed,
    num_samples: int,
    weights,
    flip,
    mean_impute: bool = True,
    sample_idx=None,
    **_ignored,
) -> ScoreResult | None:
    """C++ sparse-complement provider (pgen_native.cpp
    pgen_score_moments): hom-ref samples of non-flipped variants cost
    nothing, flipped variants reduce to a per-variant constant plus
    sparse corrections. Returns None when unavailable (caller falls
    back to the dgemm path)."""
    try:
        from pgen_tpu.native import HAVE_NATIVE, native
    except ImportError:
        return None
    if not HAVE_NATIVE or not getattr(native, "has_score_moments", False):
        return None
    packed = np.asarray(packed, dtype=np.uint8)
    weights = np.asarray(weights, dtype=np.float64)
    flip = np.asarray(flip, dtype=bool)
    nvar = packed.shape[0]
    if weights.ndim != 2 or weights.shape[0] != nvar or flip.shape != (nvar,):
        raise ValueError(
            f"score: weights {weights.shape} / flip {flip.shape} do not "
            f"match {nvar} variants"
        )
    s = num_samples
    if sample_idx is None:
        rows = None
        n_kept = s
        keep = np.ones(s, dtype=np.uint8)
    else:
        rows = np.asarray(sample_idx)
        if rows.size and (rows.min() < 0 or rows.max() >= s):
            # negative/out-of-range indices: defer to numpy's own
            # fancy-index semantics (from-the-end / IndexError) so the
            # providers never diverge on the same inputs
            return None
        if len(np.unique(rows)) != len(rows):
            return None  # duplicated indices: numpy column-gather semantics
        n_kept = len(rows)
        keep = np.zeros(s, dtype=np.uint8)
        keep[rows] = 1
    waug = np.ascontiguousarray(
        np.concatenate([weights, np.ones((nvar, 1))], axis=1)
    )
    sums_full, miss_full, base, m_used = native.score_moments(
        packed, keep, flip.astype(np.uint8), waug, mean_impute, n_kept, s,
    )
    if rows is None:
        aug = sums_full
        miss = miss_full
    else:
        aug = sums_full[rows]
        miss = miss_full[rows]
    aug += base[None, :]
    if mean_impute:
        ct = np.full(n_kept, 2 * m_used, dtype=np.int64)
    else:
        ct = 2 * (m_used - miss)
    return ScoreResult(aug[:, :-1], aug[:, -1], ct, m_used)


def score(
    packed, num_samples: int, weights, flip, provider: str = "numpy", **kw
) -> ScoreResult:
    """Provider dispatch. `native` = the C++ sparse-complement kernel
    (numpy/BLAS fallback); `device` shards the variant axis over all
    local devices when more than one is visible (dosage/imputation is
    per-variant, so shard-local stats ARE the global stats)."""
    if provider == "native":
        r = score_native(packed, num_samples, weights, flip, **kw)
        if r is not None:
            return r
        provider = "numpy"
    if provider == "device":
        import jax

        from pgen_tpu.pipeline.device import device_backend

        device_backend()

        if len(jax.devices()) > 1:
            return score_mesh(np.asarray(packed), num_samples, weights,
                              flip, **kw)
        return score_device(
            np.asarray(packed), num_samples, weights, flip,
            **kw,
        )
    return score_numpy(packed, num_samples, weights, flip, **kw)


def score_mesh(
    packed: np.ndarray,
    num_samples: int,
    weights,
    flip,
    mean_impute: bool = True,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> ScoreResult:
    """Variant-sharded scoring over all local devices (psum mesh step)."""
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    nvar = int(packed.shape[0])
    ns = num_samples if sample_idx is None else len(sample_idx)
    weights = np.asarray(weights, dtype=np.float32)
    if nvar == 0:
        return ScoreResult(
            np.zeros((ns, weights.shape[1])), np.zeros(ns),
            np.zeros(ns, np.int64), 0,
        )
    mesh = make_mesh()
    n = mesh.devices.size
    padded = pad_to_multiple(np.asarray(packed, dtype=np.uint8), n)
    npad = padded.shape[0]
    if npad != nvar:  # fresh pad rows -> all-missing (0xFF), zero weight
        padded[nvar:] = 0xFF
    wpad = np.zeros((npad, weights.shape[1]), dtype=np.float32)
    wpad[:nvar] = weights
    fpad = np.zeros(npad, dtype=bool)
    fpad[:nvar] = np.asarray(flip, bool)
    step = build_score_mesh_step(
        mesh, num_samples, weights.shape[1], mean_impute=mean_impute,
        block_variants=block_variants, sample_idx=sample_idx,
    )
    sums, dosage, ct, m = step(padded, wpad, fpad)
    ct = np.asarray(ct, np.int64)
    if ct.ndim == 0:
        ct = np.full(ns, int(ct), dtype=np.int64)
    return ScoreResult(
        np.asarray(sums, np.float64), np.asarray(dosage, np.float64),
        ct, int(m),
    )


def build_score_mesh_step(
    mesh,
    num_samples: int,
    num_scores: int,
    mean_impute: bool = True,
    block_variants: int = 1 << 14,
    sample_idx=None,
):
    """Variant-sharded scoring: per-shard dosage matmuls + one psum.

    packed (V, R) u8 / weights (V, K) f32 / flip (V,) bool all shard as
    P('v', ...); pad rows must be 0xFF with zero weight. The (S, K) f32
    partials and the count psums over the variant axis are the only
    collectives — per-variant imputation needs no pre-pass."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgen_tpu.parallel.mesh import VARIANT_AXIS
    from pgen_tpu.pipeline.device import device_backend

    device_backend()
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)

    def step(packed, weights, flip):
        def inner(packed_l, weights_l, flip_l):
            sums, dosage, ct, m = _score_device_jit(
                packed_l, weights_l, flip_l, sel, num_samples,
                mean_impute, block_variants,
            )
            return (
                jax.lax.psum(sums, VARIANT_AXIS),
                jax.lax.psum(dosage, VARIANT_AXIS),
                jax.lax.psum(ct, VARIANT_AXIS),
                jax.lax.psum(m, VARIANT_AXIS),
            )

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None), P(VARIANT_AXIS, None),
                      P(VARIANT_AXIS)),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )(packed, weights, flip)

    in_shardings = (
        NamedSharding(mesh, P(VARIANT_AXIS, None)),
        NamedSharding(mesh, P(VARIANT_AXIS, None)),
        NamedSharding(mesh, P(VARIANT_AXIS)),
    )
    return jax.jit(step, in_shardings=in_shardings)
