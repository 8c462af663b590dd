"""Pairwise IBD sharing (PLINK --genome analog): IBS counts + method of
moments Z0/Z1/Z2/PI_HAT.

An extension over the reference (whose scope stops at query/filter,
/root/reference/README.md:3-5), continuing the matmul-workload family
(ops/king.py): plink 1.9's `--genome` pairwise IBD report, which plink2
dropped in favor of KING — both live here, because the PI_HAT/Z columns
are still what many downstream QC pipelines consume.

Observed IBS counts are Gram matmuls of 0/1 indicators over the variant
axis. With H=het, R=homref, A=homalt (V x S indicators) and C = R + H + A
(called):

    HETHET = H^T H          RR = R^T R          AA = A^T A
    RA     = R^T A          NSNP = C^T C

    IBS0 = RA + RA^T                    (opposite homozygotes)
    IBS2 = RR + HETHET + AA             (identical genotypes)
    IBS1 = NSNP - IBS0 - IBS2

so the whole op is FIVE Gram matmuls per variant block (10 * V * S^2
MACs). Exactness follows ops/king.py: 0/1 indicators are exact in bf16,
`preferred_element_type=float32` accumulates integers exactly below 2^24;
callers with more variants chunk and sum in f64 (pipeline/genome.py does).

Method of moments (Purcell et al. 2007, PLINK's estimator, uncorrected
form — the finite-sample bias corrections are O(1/S) and negligible for
cohort-scale S; documented deviation): per variant with cohort ALT
frequency p (q = 1 - p), the IBS-state probabilities conditional on the
IBD state Z are

    P(IBS0|Z0) = 2 p^2 q^2
    P(IBS1|Z0) = 4 p^3 q + 4 p q^3        P(IBS1|Z1) = 2 p^2 q + 2 p q^2
    P(IBS2|Z0) = p^4 + q^4 + 4 p^2 q^2    P(IBS2|Z1) = p^3 + q^3 + p^2 q + p q^2
    P(IBS2|Z2) = 1

(each column sums to 1). Missingness is handled as in plink: expectations
use the MEAN per-variant probability over the kept variants, scaled by
each pair's both-called count NSNP. The triangular solve

    Z0 = I0 / (N m00)
    Z1 = (I1 - Z0 N m10) / (N m11)
    Z2 = (I2 - Z0 N m20 - Z1 N m21) / N

is then clamped to the simplex (each Z bounded to [0, 1], renormalized to
sum 1 — plink's bounding, simplified) and PI_HAT = Z1/2 + Z2,
DST = (IBS2 + IBS1/2) / NSNP.

Zero-padding rule: pad variant rows are 0xFF bytes (= 4 missing calls),
contributing to none of the five Grams.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np


class IbdCounts(NamedTuple):
    """Integer pair-count Grams, each (S, S), f64 on host.

    hethet[i,j] = #{v: both het}; ra[i,j] = #{v: i homref, j homalt};
    rr / aa = both-homref / both-homalt; nsnp = both called.
    """

    hethet: np.ndarray
    ra: np.ndarray
    rr: np.ndarray
    aa: np.ndarray
    nsnp: np.ndarray


def ibs_from_counts(c: IbdCounts):
    """Derive (ibs0, ibs1, ibs2) pair-count matrices from the Grams."""
    ibs0 = c.ra + c.ra.T
    ibs2 = c.rr + c.hethet + c.aa
    ibs1 = c.nsnp - ibs0 - ibs2
    return ibs0, ibs1, ibs2


def ibd_counts_reference(codes: np.ndarray) -> IbdCounts:
    """Brute-force O(S^2 * V) oracle over a (V, S) u8 code matrix."""
    codes = np.asarray(codes, dtype=np.uint8)
    _, ns = codes.shape
    out = [np.zeros((ns, ns), dtype=np.float64) for _ in range(5)]
    hethet, ra, rr, aa, nsnp = out
    for i in range(ns):
        ci = codes[:, i]
        for j in range(ns):
            cj = codes[:, j]
            both = (ci != 3) & (cj != 3)
            hethet[i, j] = np.sum(both & (ci == 1) & (cj == 1))
            ra[i, j] = np.sum(both & (ci == 0) & (cj == 2))
            rr[i, j] = np.sum(both & (ci == 0) & (cj == 0))
            aa[i, j] = np.sum(both & (ci == 2) & (cj == 2))
            nsnp[i, j] = np.sum(both)
    return IbdCounts(*out)


def ibd_counts_numpy(
    packed: np.ndarray,
    num_samples: int,
    block_variants: int = 1 << 12,
    sample_idx=None,
) -> IbdCounts:
    """Host provider: blocked BLAS sgemm Grams, f64 cross-block sums.

    Indicator buffers are preallocated and refilled in place (first-touch
    tax, see ops/king.py king_counts_numpy)."""
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    ns = num_samples if sample_idx is None else len(sample_idx)
    sums = [np.zeros((ns, ns), dtype=np.float64) for _ in range(5)]
    bv = min(block_variants, max(nvar, 1))
    bufs = np.empty((4, bv, ns), dtype=np.float32)  # H, R, A, C
    cmp = np.empty((bv, ns), dtype=bool)
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        n = codes.shape[0]
        h, r, a, c = (bufs[k, :n] for k in range(4))
        cb = cmp[:n]
        for out, code in ((h, 1), (r, 0), (a, 2)):
            np.equal(codes, code, out=cb)
            np.copyto(out, cb, casting="unsafe")
        np.add(h, r, out=c)
        c += a
        sums[0] += h.T @ h
        sums[1] += r.T @ a
        sums[2] += r.T @ r
        sums[3] += a.T @ a
        sums[4] += c.T @ c
    return IbdCounts(*sums)


def _block_grams(codes):
    """Five Gram matmuls of one block's (Vb, S) codes, bf16 in, f32 accum."""
    import jax.numpy as jnp

    ind = tuple((codes == k).astype(jnp.bfloat16) for k in (1, 0, 2))
    h, r, a = ind
    c = (codes != 3).astype(jnp.bfloat16)
    dot = functools.partial(jnp.matmul, preferred_element_type=jnp.float32)
    return dot(h.T, h), dot(r.T, a), dot(r.T, r), dot(a.T, a), dot(c.T, c)


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _ibd_counts_device_jit(
    packed, num_samples: int, block_variants: int
):
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)

    def body(carry, blk):
        codes = unpack_codes(blk, num_samples)
        g = _block_grams(codes)
        return tuple(acc + d for acc, d in zip(carry, g)), None

    init = tuple(
        jnp.zeros((num_samples, num_samples), dtype=jnp.float32)
        for _ in range(5)
    )
    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    grams, _ = jax.lax.scan(body, init, blocks)
    return grams


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _ibd_counts_device_sel_jit(
    packed, sel, num_samples: int, block_variants: int
):
    """Cohort variant: gather kept sample columns before the Grams."""
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)

    def body(carry, blk):
        codes = unpack_codes(blk, num_samples)
        codes = jnp.take(codes, sel, axis=1)
        g = _block_grams(codes)
        return tuple(acc + d for acc, d in zip(carry, g)), None

    ns = sel.shape[0]
    init = tuple(jnp.zeros((ns, ns), dtype=jnp.float32) for _ in range(5))
    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    grams, _ = jax.lax.scan(body, init, blocks)
    return grams


def ibd_counts_device(
    packed,
    num_samples: int,
    block_variants: int = 1 << 15,
    sample_idx=None,
) -> IbdCounts:
    """Device provider: bf16 indicator Grams, f32 accumulation.

    Exact while total variants < 2^24 (asserted); chunk calls above that.
    """
    nvar = int(packed.shape[0])
    if nvar >= 1 << 24:
        raise ValueError(
            f"ibd_counts_device: {nvar} variants >= 2^24 exceeds exact f32 "
            "accumulation; chunk calls and sum in f64 (pipeline/genome.py "
            "does)"
        )
    ns_out = num_samples if sample_idx is None else len(sample_idx)
    if nvar == 0:
        z = np.zeros((ns_out, ns_out), dtype=np.float64)
        return IbdCounts(*(z.copy() for _ in range(5)))
    bv = min(block_variants, 1 << 24)
    if sample_idx is None:
        out = _ibd_counts_device_jit(packed, num_samples, bv)
    else:
        out = _ibd_counts_device_sel_jit(
            packed, np.asarray(sample_idx, dtype=np.int32),
            num_samples, bv,
        )
    return IbdCounts(*(np.asarray(g, dtype=np.float64) for g in out))


def ibd_counts_mesh(
    packed: np.ndarray,
    num_samples: int,
    block_variants: int = 1 << 15,
    sample_idx=None,
) -> IbdCounts:
    """Variant-sharded Grams over all local devices (psum mesh step)."""
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    nvar = int(packed.shape[0])
    if nvar >= 1 << 24:
        raise ValueError(
            f"ibd_counts_mesh: {nvar} variants >= 2^24 exceeds exact f32 "
            "accumulation; chunk calls and sum in f64 (pipeline/genome.py "
            "does)"
        )
    ns_out = num_samples if sample_idx is None else len(sample_idx)
    if nvar == 0:
        z = np.zeros((ns_out, ns_out), dtype=np.float64)
        return IbdCounts(*(z.copy() for _ in range(5)))
    mesh = make_mesh()
    ndev = mesh.devices.size
    padded = pad_to_multiple(np.asarray(packed, dtype=np.uint8), ndev)
    if padded.shape[0] != nvar:  # fresh pad rows -> all-missing (0xFF)
        padded[nvar:] = 0xFF
    step = build_ibd_mesh_step(
        mesh, num_samples,
        block_variants=min(block_variants, 1 << 24),
        sample_idx=sample_idx,
    )
    out = step(padded)
    return IbdCounts(*(np.asarray(g, dtype=np.float64) for g in out))


def build_ibd_mesh_step(
    mesh, num_samples: int, block_variants: int = 1 << 15, sample_idx=None
):
    """Variant-sharded mesh IBD Grams: per-shard scan + one 5-tensor psum
    (the only collective, 5*S^2 f32); output replicated. Mirrors
    ops/king.py build_king_mesh_step."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgen_tpu.parallel.mesh import VARIANT_AXIS
    from pgen_tpu.pipeline.device import device_backend

    device_backend()
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)

    def step(packed):
        def inner(packed_l):
            if sel is None:
                grams = _ibd_counts_device_jit(
                    packed_l, num_samples, block_variants
                )
            else:
                grams = _ibd_counts_device_sel_jit(
                    packed_l, sel, num_samples, block_variants
                )
            return tuple(jax.lax.psum(g, VARIANT_AXIS) for g in grams)

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None),),
            out_specs=tuple(P() for _ in range(5)),
            check_vma=False,
        )(packed)

    in_shardings = (NamedSharding(mesh, P(VARIANT_AXIS, None)),)
    return jax.jit(step, in_shardings=in_shardings)


def ibd_counts(
    packed: np.ndarray, num_samples: int, provider: str = "numpy", **kw
) -> IbdCounts:
    """Provider dispatch (same convention as ops/king.py king_counts)."""
    if provider == "device":
        import jax

        from pgen_tpu.pipeline.device import device_backend

        device_backend()

        if len(jax.devices()) > 1:
            return ibd_counts_mesh(np.asarray(packed), num_samples, **kw)
        return ibd_counts_device(
            np.asarray(packed), num_samples,
            **kw,
        )
    return ibd_counts_numpy(packed, num_samples, **kw)


def ibd_estimates(counts: IbdCounts, alt_freq: np.ndarray):
    """Method-of-moments Z0/Z1/Z2/PI_HAT from the count Grams + cohort
    ALT frequencies of the kept variants (NaN freqs — zero-called
    variants — are excluded from the expectation means).

    Returns dict of (S, S) arrays: ibs0/ibs1/ibs2 (counts), dst, z0, z1,
    z2, pi_hat. Pairs with NSNP == 0, or a fileset whose kept variants
    carry no IBS information (all monomorphic -> m00 == 0), come out NaN.
    """
    ibs0, ibs1, ibs2 = ibs_from_counts(counts)
    p = np.asarray(alt_freq, dtype=np.float64)
    p = p[np.isfinite(p)]
    q = 1.0 - p
    if p.size:
        m00 = float(np.mean(2 * p**2 * q**2))
        m10 = float(np.mean(4 * p**3 * q + 4 * p * q**3))
        m20 = float(np.mean(p**4 + q**4 + 4 * p**2 * q**2))
        m11 = float(np.mean(2 * p**2 * q + 2 * p * q**2))
        m21 = float(np.mean(p**3 + q**3 + p**2 * q + p * q**2))
    else:
        m00 = m10 = m20 = m11 = m21 = 0.0

    n = counts.nsnp
    with np.errstate(divide="ignore", invalid="ignore"):
        dst = np.where(n > 0, (ibs2 + 0.5 * ibs1) / np.maximum(n, 1), np.nan)
        if m00 > 0 and m11 > 0:
            z0 = ibs0 / (n * m00)
            z1 = (ibs1 - z0 * n * m10) / (n * m11)
            z2 = (ibs2 - z0 * n * m20 - z1 * n * m21) / n
        else:
            z0 = np.full_like(dst, np.nan)
            z1 = np.full_like(dst, np.nan)
            z2 = np.full_like(dst, np.nan)
        bad = ~(n > 0)
        # plink-style bounding, simplified: clamp each Z to [0, 1] and
        # renormalize so the triple stays on the simplex
        z0 = np.clip(z0, 0.0, 1.0)
        z1 = np.clip(z1, 0.0, 1.0)
        z2 = np.clip(z2, 0.0, 1.0)
        tot = z0 + z1 + z2
        ok = tot > 0
        z0 = np.where(ok, z0 / np.where(ok, tot, 1), np.nan)
        z1 = np.where(ok, z1 / np.where(ok, tot, 1), np.nan)
        z2 = np.where(ok, z2 / np.where(ok, tot, 1), np.nan)
        for z in (z0, z1, z2):
            z[bad] = np.nan
        pi_hat = 0.5 * z1 + z2
    return {
        "ibs0": ibs0, "ibs1": ibs1, "ibs2": ibs2, "dst": dst,
        "z0": z0, "z1": z1, "z2": z2, "pi_hat": pi_hat,
    }
