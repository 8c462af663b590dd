"""Principal components of the genotype matrix via the GRM (matmul workload).

The plink2 `--pca` analog (extension — the reference is a query/filter
tool, /root/reference/README.md:3-5). Method: the exact small-cohort path
plink2 itself defaults to — build the S x S genetic relationship matrix
from the standardized genotype matrix and eigendecompose it on host.

Standardization (per variant v, over CALLED samples):
    dosage g in {0, 1, 2};  p_v = alt-allele frequency = AC / (2 * NOBS)
    z_vs = (g_vs - 2 p_v) / sqrt(2 p_v (1 - p_v))   if called
         = 0                                        if missing (mean impute)
Monomorphic / all-missing variants have sd 0 and are excluded (they carry
no signal; z rows forced to 0, not counted in the divisor).

    GRM = Z^T Z / M_used     (M_used = polymorphic variant count)

GRM accumulation is one f32 Gram matmul per variant block (2*V*S^2 MACs)
— matmul work on the device provider, blocked BLAS on host. The S x S
eigendecomposition runs on host (LAPACK eigh, f64): S ~ 10^3-10^4 makes
it milliseconds-to-seconds, far off the critical path.

Precision: unlike the integer KING Grams (ops/king.py), z values are real,
so blocks accumulate in f32 (device) and the cross-block sum is f64 on
host; eigenvector quality is set by the f32 Gram, fine for PCs (plink2's
approximate mode tolerates far more). Sign convention: each eigenvector is
flipped so its largest-|entry| component is positive (deterministic across
providers/meshes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np


class GrmResult(NamedTuple):
    grm_sum: np.ndarray  # (S, S) f64: sum of z^T z over used variants
    m_used: int  # polymorphic (sd > 0) variant count


def grm_numpy(
    packed: np.ndarray,
    num_samples: int,
    block_variants: int = 1 << 13,
    sample_idx=None,
) -> GrmResult:
    """Host provider: f64 standardize + dgemm Gram per block.

    All block-sized arrays are preallocated once and updated in place:
    on hypervisors with lazy page backing, every fresh numpy temporary
    pays a ~0.25 GB/s first-touch tax (see ROADMAP.md Host IO), which
    would otherwise cost several times the dgemm itself.
    """
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    ns = num_samples if sample_idx is None else len(sample_idx)
    acc = np.zeros((ns, ns), dtype=np.float64)
    bv = min(block_variants, max(nvar, 1))
    zf = np.empty((bv, ns), dtype=np.float64)
    called = np.empty((bv, ns), dtype=bool)
    m_used = 0
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        n = codes.shape[0]
        z, cal = zf[:n], called[:n]
        np.not_equal(codes, 3, out=cal)
        np.copyto(z, codes, casting="unsafe")
        z *= cal  # g: missing -> 0
        n_called = cal.sum(axis=1)
        ac = z.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.where(n_called > 0, ac / np.maximum(2.0 * n_called, 1.0), 0.0)
        var = 2.0 * p * (1.0 - p)
        used = var > 0
        inv_sd = np.where(used, 1.0 / np.sqrt(np.maximum(var, 1e-300)), 0.0)
        z -= (2.0 * p)[:, None]
        z *= inv_sd[:, None]  # 0 for unused rows
        z *= cal  # re-zero missing entries
        acc += z.T @ z
        m_used += int(used.sum())
    return GrmResult(acc, m_used)


def _standardize_block_jnp(codes):
    import jax.numpy as jnp

    called = codes != 3
    g = codes.astype(jnp.float32) * called
    n_called = jnp.sum(called, axis=1).astype(jnp.float32)
    ac = jnp.sum(g, axis=1)
    p = jnp.where(n_called > 0, ac / jnp.maximum(2.0 * n_called, 1.0), 0.0)
    var = 2.0 * p * (1.0 - p)
    used = var > 0
    inv_sd = jnp.where(used, jax.lax.rsqrt(jnp.maximum(var, 1e-30)), 0.0)
    z = (g - 2.0 * p[:, None]) * inv_sd[:, None] * called * used[:, None]
    return z, used


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _grm_device_jit(packed, sel, num_samples, block_variants):
    """Blocked scan: unpack -> standardize -> f32 Gram accumulate.

    sel is an i32 column-gather vector or None (keep-all fast path, no
    gather). 0xFF pad rows are all-missing: z = 0, used = False.
    """
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)
    ns = num_samples if sel is None else sel.shape[0]

    def body(carry, blk):
        acc, m = carry
        codes = unpack_codes(blk, num_samples)
        if sel is not None:
            codes = jnp.take(codes, sel, axis=1)
        z, used = _standardize_block_jnp(codes)
        # HIGHEST: full f32 — a default-precision f32 matmul may run in
        # TF32 on the GPU, whose ~1e-3 relative error is too coarse for
        # eigenvector work (KING's 0/1 Grams are exact in
        # bf16; standardized z values are not)
        acc = acc + jnp.matmul(
            z.T, z,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return (acc, m + jnp.sum(used.astype(jnp.int32))), None

    init = (jnp.zeros((ns, ns), dtype=jnp.float32), jnp.zeros((), jnp.int32))
    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    (acc, m_used), _ = jax.lax.scan(body, init, blocks)
    return acc, m_used


def grm_device(
    packed,
    num_samples: int,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> GrmResult:
    if packed.shape[0] == 0:
        ns = num_samples if sample_idx is None else len(sample_idx)
        return GrmResult(np.zeros((ns, ns), dtype=np.float64), 0)
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)
    acc, m = _grm_device_jit(packed, sel, num_samples, block_variants)
    return GrmResult(np.asarray(acc, dtype=np.float64), int(m))


def grm(packed, num_samples: int, provider: str = "numpy", **kw) -> GrmResult:
    """Provider dispatch (`native` -> numpy: BLAS is the host gemm engine).
    `device` shards the variant axis over all local devices when more
    than one is visible (standardization is per-variant, so shard-local
    stats ARE the global stats)."""
    if provider == "device":
        import jax

        from pgen_tpu.pipeline.device import device_backend

        device_backend()

        if len(jax.devices()) > 1:
            return grm_mesh(np.asarray(packed), num_samples, **kw)
        return grm_device(
            np.asarray(packed), num_samples,
            **kw,
        )
    return grm_numpy(packed, num_samples, **kw)


def grm_mesh(
    packed: np.ndarray,
    num_samples: int,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> GrmResult:
    """Variant-sharded GRM over all local devices (psum mesh step)."""
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    nvar = int(packed.shape[0])
    ns = num_samples if sample_idx is None else len(sample_idx)
    if nvar == 0:
        return GrmResult(np.zeros((ns, ns), dtype=np.float64), 0)
    mesh = make_mesh()
    padded = pad_to_multiple(np.asarray(packed, dtype=np.uint8), mesh.devices.size)
    if padded.shape[0] != nvar:  # fresh pad rows -> all-missing (0xFF)
        padded[nvar:] = 0xFF
    step = build_grm_mesh_step(
        mesh, num_samples, block_variants=block_variants, sample_idx=sample_idx
    )
    acc, m = step(padded)
    return GrmResult(np.asarray(acc, dtype=np.float64), int(m))


def pca_from_grm(grm_sum: np.ndarray, m_used: int, k: int):
    """Top-k eigenpairs of GRM = grm_sum / m_used, descending, sign-fixed.

    Returns (eigenvalues (k,), eigenvectors (S, k)) with each column
    scaled to unit norm; ties/negatives kept as eigh reports them.
    """
    if m_used <= 0:
        raise ValueError("pca: no polymorphic variants after filtering")
    g = grm_sum / float(m_used)
    vals, vecs = np.linalg.eigh((g + g.T) / 2.0)  # symmetrize f32 noise
    order = np.argsort(vals)[::-1][:k]
    vals, vecs = vals[order], vecs[:, order]
    # deterministic sign: the largest-|entry| component is positive
    flip = np.sign(vecs[np.argmax(np.abs(vecs), axis=0), np.arange(vecs.shape[1])])
    flip = np.where(flip == 0, 1.0, flip)
    return vals, vecs * flip


def _standardize_block_numpy(codes: np.ndarray):
    """f64 standardized dosage block (same formula as grm_numpy's in-place
    path): missing mean-imputed to 0, monomorphic rows zeroed."""
    cal = codes != 3
    z = codes.astype(np.float64) * cal
    n_called = cal.sum(axis=1)
    ac = z.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(n_called > 0, ac / np.maximum(2.0 * n_called, 1.0), 0.0)
    var = 2.0 * p * (1.0 - p)
    used = var > 0
    inv_sd = np.where(used, 1.0 / np.sqrt(np.maximum(var, 1e-300)), 0.0)
    z -= (2.0 * p)[:, None]
    z *= inv_sd[:, None]
    z *= cal
    return z, used


class PcaApproxResult(NamedTuple):
    eigenvalues: np.ndarray  # (k,) Rayleigh-Ritz estimates, descending
    eigenvectors: np.ndarray  # (S, k) unit-norm, sign-fixed
    m_used: int


def pca_approx(
    packed,
    num_samples: int,
    k: int,
    provider: str = "numpy",
    block_variants: int | None = None,
    sample_idx=None,
    iters: int = 10,
    oversample: int = 8,
    seed: int = 1,
) -> PcaApproxResult:
    """Randomized top-k PCA WITHOUT materializing the S x S GRM.

    Blocked subspace (power) iteration on the standardized dosage matrix Z
    (M x S) — the FastPCA/plink2 `--pca approx` family (Galinsky 2016):

        Q_0 = orth(Gaussian (S, L)),  L = k + oversample
        Q_{t+1} = orth( Z^T (Z Q_t) / M )      x iters
        C = Q^T (Z^T Z Q / M)  (L x L Rayleigh-Ritz),  eigh(C) -> (lam, W)
        V = Q W[:, :k]

    Every data touch is a tall-skinny matmul pair per variant block —
    z_b @ Q (bv x L) then z_b^T @ that (S x L accumulate) — matmul-shaped on
    the device provider, dgemm on host; the only O(S) state is the (S, L)
    subspace, so S ~ 10^5+ cohorts run in bounded memory where the exact
    S x S Gram (plink2's default small-cohort path, grm()) cannot.
    Host-side QR between passes is (S, L) — milliseconds.

    Deterministic for a fixed seed across providers up to f32 Gram noise.
    """
    packed = np.asarray(packed, dtype=np.uint8)
    ns = num_samples if sample_idx is None else len(sample_idx)
    if k < 1:
        raise ValueError("pca approx: k must be >= 1")
    L = min(ns, k + max(0, oversample))
    if L < k:
        raise ValueError(f"pca approx: k={k} exceeds {ns} samples")
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((ns, L)))[0]

    if provider == "device":
        pass_fn = _make_approx_pass_device(
            packed, num_samples, sample_idx, block_variants
        )
    else:
        pass_fn = _make_approx_pass_numpy(
            packed, num_samples, sample_idx, block_variants
        )

    m_used = 0
    y = None
    for _ in range(max(1, iters)):
        y, m_used = pass_fn(q)
        if m_used <= 0:
            raise ValueError("pca: no polymorphic variants after filtering")
        y /= float(m_used)
        q = np.linalg.qr(y)[0]
    # Rayleigh-Ritz on the converged subspace: one more data pass
    y, m_used = pass_fn(q)
    y /= float(m_used)
    c = q.T @ y
    c = (c + c.T) / 2.0
    vals, w = np.linalg.eigh(c)
    order = np.argsort(vals)[::-1][:k]
    vals = vals[order]
    vecs = q @ w[:, order]
    vecs /= np.linalg.norm(vecs, axis=0, keepdims=True)
    flip = np.sign(vecs[np.argmax(np.abs(vecs), axis=0), np.arange(vecs.shape[1])])
    flip = np.where(flip == 0, 1.0, flip)
    return PcaApproxResult(vals, vecs * flip, int(m_used))


def _make_approx_pass_numpy(packed, num_samples, sample_idx, block_variants):
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    nvar = packed.shape[0]
    bv = min(block_variants or (1 << 13), max(nvar, 1))

    def pass_fn(q):
        ns = q.shape[0]
        y = np.zeros((ns, q.shape[1]), dtype=np.float64)
        m_used = 0
        for lo in range(0, nvar, bv):
            codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
            if sample_idx is not None:
                codes = codes[:, sample_idx]
            z, used = _standardize_block_numpy(codes)
            y += z.T @ (z @ q)
            m_used += int(used.sum())
        return y, m_used

    return pass_fn


def _make_approx_pass_device(packed, num_samples, sample_idx, block_variants):
    """One jitted blocked scan per pass: unpack -> standardize -> the two
    tall-skinny f32 matmuls, accumulated on device. Multi-device meshes
    shard the variant axis and psum the (S, L) partial — the same
    collective shape as the mesh GRM step, but L-wide instead of S-wide."""
    import jax.numpy as jnp

    from pgen_tpu.pipeline.device import device_backend

    device_backend()
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)
    nvar = int(packed.shape[0])
    bv = min(block_variants or (1 << 14), max(nvar, 1))
    ndev = len(jax.devices())
    use_mesh = ndev > 1

    if use_mesh:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pgen_tpu.parallel.mesh import VARIANT_AXIS, make_mesh, pad_to_multiple

        mesh = make_mesh()
        padded = pad_to_multiple(np.asarray(packed, dtype=np.uint8), ndev)
        if padded.shape[0] != nvar:
            padded[nvar:] = 0xFF  # all-missing pad rows: z = 0, not counted

        def step(packed_g, q):
            def inner(packed_l, q_l):
                y, m = _approx_pass_jit(packed_l, q_l, sel, num_samples, bv)
                return (
                    jax.lax.psum(y, VARIANT_AXIS),
                    jax.lax.psum(m, VARIANT_AXIS),
                )

            return jax.shard_map(
                inner,
                mesh=mesh,
                in_specs=(P(VARIANT_AXIS, None), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )(packed_g, q)

        jitted = jax.jit(
            step,
            in_shardings=(
                NamedSharding(mesh, P(VARIANT_AXIS, None)),
                NamedSharding(mesh, P()),
            ),
        )

        def pass_fn(q):
            y, m = jitted(padded, q.astype(np.float32))
            return np.asarray(y, dtype=np.float64), int(m)

        return pass_fn

    packed_a = np.asarray(packed, dtype=np.uint8)

    def pass_fn(q):
        y, m = _approx_pass_jit(
            packed_a, q.astype(np.float32), sel, num_samples, bv
        )
        return np.asarray(y, dtype=np.float64), int(m)

    return pass_fn


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _approx_pass_jit(packed, q, sel, num_samples, block_variants):
    """y = sum_blocks z_b^T (z_b q), m = polymorphic count (f32 HIGHEST)."""
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)
    ns = num_samples if sel is None else sel.shape[0]

    def body(carry, blk):
        acc, m = carry
        codes = unpack_codes(blk, num_samples)
        if sel is not None:
            codes = jnp.take(codes, sel, axis=1)
        z, used = _standardize_block_jnp(codes)
        zq = jnp.matmul(
            z, q,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        acc = acc + jnp.matmul(
            z.T, zq,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return (acc, m + jnp.sum(used.astype(jnp.int32))), None

    init = (
        jnp.zeros((ns, q.shape[1]), dtype=jnp.float32),
        jnp.zeros((), jnp.int32),
    )
    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    (acc, m), _ = jax.lax.scan(body, init, blocks)
    return acc, m


def build_grm_mesh_step(
    mesh, num_samples: int, block_variants: int = 1 << 14, sample_idx=None
):
    """Variant-sharded GRM: per-shard standardized Grams + one psum.

    packed (V, R) u8 shards as P('v', None); pad rows must be 0xFF
    (all-missing). The (S, S) f32 partial and the used-count psum over the
    variant axis are the only collectives. Standardization is per-variant,
    so shard-local stats ARE the global stats — no pre-pass collective.
    sample_idx (optional) restricts columns (replicated gather vector).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgen_tpu.parallel.mesh import VARIANT_AXIS
    from pgen_tpu.pipeline.device import device_backend

    device_backend()
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)

    def step(packed):
        def inner(packed_l):
            acc, m = _grm_device_jit(
                packed_l, sel, num_samples, block_variants
            )
            return (
                jax.lax.psum(acc, VARIANT_AXIS),
                jax.lax.psum(m, VARIANT_AXIS),
            )

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None),),
            out_specs=(P(), P()),
            check_vma=False,
        )(packed)

    in_shardings = (NamedSharding(mesh, P(VARIANT_AXIS, None)),)
    return jax.jit(step, in_shardings=in_shardings)
