"""Pairwise KING-robust kinship: the framework's first matmul-bound op.

Everything else in the engine is HBM-bandwidth bound (decode, text, stats
reductions); relatedness estimation is the classic genetics workload that
is genuinely matmul-shaped, so it runs as Gram matmuls. This is capability the
reference does not have (its scope is query/filter, /root/reference/
README.md:3-5) — the plink2 `--make-king-table` analog for mode-0x02
hard-call filesets.

Estimator (Manichaikul et al. 2010, the between-family "robust" form —
no allele-frequency estimates needed, so it is exact integer arithmetic):

    phi(i,j) = (N_HetHet - 2 * N_IBS0) / (N_Het(i) + N_Het(j))

with every count taken over variants where BOTH i and j are called:
    N_HetHet = #{v : i het AND j het}
    N_IBS0   = #{v : opposite homozygotes (0/0 vs 1/1)}
    N_Het(i) = #{v : i het AND j called}   (pairwise-complete, as in KING)

Each count is an inner product over the variant axis of 0/1 indicator
matrices -> an S x S Gram matrix via matmul. With H=het, R=homref,
A=homalt (V x S indicators) and C = R + H + A (called):

    HetHet = H^T H
    IBS0   = R^T A + (R^T A)^T
    HetCal = H^T C          (N_Het(i) at [i, j]; N_Het(j) is its transpose)
    NSNP   = C^T C          (both-called pair denominators)

so the whole op is FOUR Gram matmuls per variant block (8 * V * S^2 MACs).

Exactness: indicators are 0/1, exact in bf16; `jnp.dot` with
`preferred_element_type=float32` accumulates in f32, which
represents every integer < 2^24 exactly — each per-block count is bounded
by the block height, and the cross-block sum is exact while the total
variant count stays < 2^24 (16.7M, beyond any single chromosome). Callers
with more variants must chunk calls and accumulate in f64 on host (the
pipeline does; see pipeline/king.py).

Zero-padding rule: variant rows are padded with 0xFF bytes (= 4 missing
calls), which contribute to none of the four Grams; the sample tail of the
last record byte is dropped by the unpack slice before indicators form.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np


class KingCounts(NamedTuple):
    """Integer pair-count Grams, each (S, S), f64 on host.

    hethet[i, j] = #{v: both het};  ra[i, j] = #{v: i homref, j homalt}
    hetcal[i, j] = #{v: i het, j called};  nsnp[i, j] = #{v: both called}
    IBS0 = ra + ra.T (derived, not stored).
    """

    hethet: np.ndarray
    ra: np.ndarray
    hetcal: np.ndarray
    nsnp: np.ndarray


def king_counts_reference(codes: np.ndarray) -> KingCounts:
    """Brute-force O(S^2 * V) oracle over a (V, S) u8 code matrix."""
    codes = np.asarray(codes, dtype=np.uint8)
    _, ns = codes.shape
    hethet = np.zeros((ns, ns), dtype=np.float64)
    ra = np.zeros((ns, ns), dtype=np.float64)
    hetcal = np.zeros((ns, ns), dtype=np.float64)
    nsnp = np.zeros((ns, ns), dtype=np.float64)
    for i in range(ns):
        ci = codes[:, i]
        for j in range(ns):
            cj = codes[:, j]
            both = (ci != 3) & (cj != 3)
            hethet[i, j] = np.sum(both & (ci == 1) & (cj == 1))
            ra[i, j] = np.sum(both & (ci == 0) & (cj == 2))
            hetcal[i, j] = np.sum(both & (ci == 1))
            nsnp[i, j] = np.sum(both)
    return KingCounts(hethet, ra, hetcal, nsnp)


def king_counts_numpy(
    packed: np.ndarray,
    num_samples: int,
    block_variants: int = 1 << 12,
    sample_idx=None,
) -> KingCounts:
    """Host provider: blocked BLAS sgemm Grams, f64 cross-block accumulation.

    Per-block counts are < block_variants <= 2^24, exact in f32; the f64
    accumulators keep exactness for any variant count. sample_idx
    (optional) restricts the Grams to that cohort's columns.

    Indicator buffers are preallocated once and refilled in place — fresh
    numpy temporaries pay a ~0.25 GB/s first-touch tax on hypervisors with
    lazy page backing (ROADMAP.md Host IO), several times the sgemm cost.
    """
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    ns = num_samples if sample_idx is None else len(sample_idx)
    hethet = np.zeros((ns, ns), dtype=np.float64)
    ra = np.zeros((ns, ns), dtype=np.float64)
    hetcal = np.zeros((ns, ns), dtype=np.float64)
    nsnp = np.zeros((ns, ns), dtype=np.float64)
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
        hethet += h.T @ h
        ra += r.T @ a
        hetcal += h.T @ c
        nsnp += c.T @ c
    return KingCounts(hethet, ra, hetcal, nsnp)


def _device_block_grams(codes_bf16):
    """4 Gram matmuls of one block's (Vb, S) bf16 indicators, f32 accum."""
    import jax.numpy as jnp

    h, r, a, c = codes_bf16
    dot = functools.partial(
        jnp.matmul, preferred_element_type=jnp.float32
    )
    return dot(h.T, h), dot(r.T, a), dot(h.T, c), dot(c.T, c)


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _king_counts_device_jit(
    packed, num_samples: int, block_variants: int
):
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    # 0xFF pad rows = all-missing: contribute to none of the Grams
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)

    def body(carry, blk):
        codes = unpack_codes(blk, num_samples)
        ind = tuple(
            (codes == k).astype(jnp.bfloat16) for k in (1, 0, 2)
        )  # H, R, A
        c = (codes != 3).astype(jnp.bfloat16)
        g = _device_block_grams((*ind, c))
        return tuple(acc + d for acc, d in zip(carry, g)), None

    init = tuple(
        jnp.zeros((num_samples, num_samples), dtype=jnp.float32)
        for _ in range(4)
    )
    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    (hethet, ra, hetcal, nsnp), _ = jax.lax.scan(body, init, blocks)
    return hethet, ra, hetcal, nsnp


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _king_counts_device_sel_jit(
    packed, sel, num_samples: int, block_variants: int
):
    """Cohort variant: gather the kept sample columns before the Grams.

    sel is an i32 index vector; the output Grams are (len(sel), len(sel)).
    Kept separate from the no-subset jit so the common keep-all path never
    pays the identity column gather."""
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)

    def body(carry, blk):
        codes = unpack_codes(blk, num_samples)
        codes = jnp.take(codes, sel, axis=1)
        ind = tuple((codes == k).astype(jnp.bfloat16) for k in (1, 0, 2))
        c = (codes != 3).astype(jnp.bfloat16)
        g = _device_block_grams((*ind, c))
        return tuple(acc + d for acc, d in zip(carry, g)), None

    ns = sel.shape[0]
    init = tuple(jnp.zeros((ns, ns), dtype=jnp.float32) for _ in range(4))
    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    (hethet, ra, hetcal, nsnp), _ = jax.lax.scan(body, init, blocks)
    return hethet, ra, hetcal, nsnp


def king_counts_device(
    packed,
    num_samples: int,
    block_variants: int = 1 << 15,
    sample_idx=None,
) -> KingCounts:
    """Device provider: bf16 indicator Grams, f32 accumulation.

    Exact while total variants < 2^24 (asserted); chunk calls above that.
    sample_idx (optional i32 vector) restricts the Grams to that cohort.
    """
    nvar = int(packed.shape[0])
    if nvar >= 1 << 24:
        raise ValueError(
            f"king_counts_device: {nvar} variants >= 2^24 exceeds exact f32 "
            "accumulation; chunk calls and sum in f64 (pipeline/king.py does)"
        )
    ns_out = num_samples if sample_idx is None else len(sample_idx)
    if nvar == 0:
        z = np.zeros((ns_out, ns_out), dtype=np.float64)
        return KingCounts(z, z.copy(), z.copy(), z.copy())
    bv = min(block_variants, 1 << 24)
    if sample_idx is None:
        out = _king_counts_device_jit(packed, num_samples, bv)
    else:
        out = _king_counts_device_sel_jit(
            packed, np.asarray(sample_idx, dtype=np.int32),
            num_samples, bv,
        )
    return KingCounts(*(np.asarray(g, dtype=np.float64) for g in out))


def king_counts(
    packed: np.ndarray, num_samples: int, provider: str = "numpy", **kw
) -> KingCounts:
    """Provider dispatch. `native` falls through to numpy (BLAS is the
    host matmul engine; there is no bespoke C++ path for a gemm).
    `device` shards the variant axis over ALL local devices when more
    than one is visible (psum mesh step); single-device scan otherwise.
    """
    if provider == "device":
        import jax

        from pgen_tpu.pipeline.device import device_backend

        device_backend()

        if len(jax.devices()) > 1:
            return king_counts_mesh(np.asarray(packed), num_samples, **kw)
        return king_counts_device(
            np.asarray(packed), num_samples,
            **kw,
        )
    return king_counts_numpy(packed, num_samples, **kw)


def king_counts_mesh(
    packed: np.ndarray,
    num_samples: int,
    block_variants: int = 1 << 15,
    sample_idx=None,
) -> KingCounts:
    """Variant-sharded Grams over all local devices (see the mesh step)."""
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    nvar = int(packed.shape[0])
    if nvar >= 1 << 24:
        raise ValueError(
            f"king_counts_mesh: {nvar} variants >= 2^24 exceeds exact f32 "
            "accumulation; chunk calls and sum in f64 (pipeline/king.py does)"
        )
    ns_out = num_samples if sample_idx is None else len(sample_idx)
    if nvar == 0:
        z = np.zeros((ns_out, ns_out), dtype=np.float64)
        return KingCounts(z, z.copy(), z.copy(), z.copy())
    mesh = make_mesh()
    ndev = mesh.devices.size
    padded = pad_to_multiple(np.asarray(packed, dtype=np.uint8), ndev)
    if padded.shape[0] != nvar:  # fresh pad rows -> all-missing (0xFF)
        padded[nvar:] = 0xFF
    step = build_king_mesh_step(
        mesh, num_samples,
        block_variants=min(block_variants, 1 << 24),
        sample_idx=sample_idx,
    )
    out = step(padded)
    return KingCounts(*(np.asarray(g, dtype=np.float64) for g in out))


def king_kinship(counts: KingCounts):
    """Derive the (S, S) robust kinship matrix + IBS0 from the count Grams.

    Entries with a zero denominator (a sample het at no both-called
    variant) are NaN, matching KING's undefined-estimate convention.
    """
    ibs0 = counts.ra + counts.ra.T
    den = counts.hetcal + counts.hetcal.T
    with np.errstate(divide="ignore", invalid="ignore"):
        kin = np.where(den > 0, (counts.hethet - 2.0 * ibs0) / den, np.nan)
    return kin, ibs0


def build_king_mesh_step(
    mesh, num_samples: int, block_variants: int = 1 << 15, sample_idx=None
):
    """Variant-sharded mesh kinship: per-shard Grams + one psum.

    packed (V, R) u8 shards as P('v', None); each device scans its local
    blocks through the indicator Grams and the four (S, S) f32 partials
    psum over the variant axis — the only collective, 4*S^2 f32.
    Output is replicated. sample_idx (optional) restricts columns via the
    replicated gather variant. Exactness bound is per-TOTAL variant count
    as in king_counts_device (psum of exact integer f32 partials stays
    exact below 2^24).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgen_tpu.parallel.mesh import VARIANT_AXIS
    from pgen_tpu.pipeline.device import device_backend

    device_backend()
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)

    def step(packed):
        def inner(packed_l):
            if sel is None:
                grams = _king_counts_device_jit(
                    packed_l, num_samples, block_variants
                )
            else:
                grams = _king_counts_device_sel_jit(
                    packed_l, sel, num_samples, block_variants
                )
            return tuple(
                jax.lax.psum(g, VARIANT_AXIS) for g in grams
            )

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None),),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )(packed)

    in_shardings = (NamedSharding(mesh, P(VARIANT_AXIS, None)),)
    return jax.jit(step, in_shardings=in_shardings)
