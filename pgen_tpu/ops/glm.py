"""Per-variant linear association (GWAS): masked-moment matmuls + batched
tiny solves (matmul workload).

The plink2 `--glm` linear-regression analog (extension — the reference is
a query/filter tool, /root/reference/README.md:3-5). For each variant v,
ordinary least squares of the phenotype on [1, covariates, dosage] over
that variant's COMPLETE CASES (samples with a called genotype), exactly
like plink2 — no imputation.

Matmul-first formulation: every per-variant normal-equation entry is a
masked sum over samples, and masked sums are matmuls. With M the (V, S)
called-mask matrix and G the (V, S) dosage matrix (missing -> 0):

    sum_s m_vs * f(s)        = M @ f      for f in {1, c_i, c_i c_j, y,
                                                     y^2, y c_i}
    sum_s g_vs * h(s)        = G @ h      for h in {y, c_i}
    sum_s g_vs^2             rides the same matmul via the identity
                             g^2 = 2*hom - g on {0,1,2} hard calls? no —
                             g^2 in {0,1,4} is its own elementwise square.

So one (V, S) x (S, P) product per variant block delivers ALL moments
(P = 2k + k(k+1)/2 + 3 columns for k covariates) — matmul work on the
device provider, dgemm on host. The (k+2)-dim normal equations then
solve batched on host LAPACK in f64 (V systems of a tiny fixed size),
far off the critical path.

Precision: moment matmuls accumulate in f32 on device
(Precision.HIGHEST true-f32 passes, same reasoning as ops/pca.py) and
f64 on host; the f32 moments bound |t-stat| error well below reporting
precision for cohort sizes this format holds (validated against the f64
host path in tests).

Per-variant outputs (plink2 .glm.linear columns): OBS_CT = n_v, BETA =
dosage coefficient, SE, T_STAT, P (two-sided, exact Student-t via the
regularized incomplete beta, Lentz continued fraction in f64). Variants
with n_v < k + 3 or zero complete-case dosage variance report NA
(matching plink2's NA rows for unestimable tests).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np


class GlmMoments(NamedTuple):
    """Per-variant complete-case moments (all f64, host-side)."""

    n: np.ndarray  # (V,) called count
    mp: np.ndarray  # (V, P) masked sums M @ P  (P = moment columns)
    gq: np.ndarray  # (V, k+1) dosage sums G @ [y, C]
    sg: np.ndarray  # (V,) sum g
    sg2: np.ndarray  # (V,) sum g^2


class GlmResult(NamedTuple):
    n_obs: np.ndarray  # (V,) i64 complete-case count
    beta: np.ndarray  # (V,) f64, NaN where unestimable
    se: np.ndarray  # (V,) f64
    t_stat: np.ndarray  # (V,) f64
    p: np.ndarray  # (V,) f64


def _centered(y: np.ndarray, covars: np.ndarray):
    """Shift y and each covariate to cohort mean zero before building the
    moment columns. The dosage BETA/SE/T are invariant to these shifts
    (the intercept absorbs them, per-variant complete-case subsets
    included), while the moment magnitudes drop by orders of magnitude —
    this is what keeps the f32 device accumulation well conditioned for
    large-magnitude covariates (e.g. birth years ~2000). Applied in every
    provider so cross-provider moment-parity holds."""
    yc = y - y.mean() if y.size else y
    cc = covars - covars.mean(axis=0) if covars.size else covars
    return yc, cc


def _moment_columns(y: np.ndarray, covars: np.ndarray) -> np.ndarray:
    """(S, P) columns whose masked sums fill the normal equations:
    [1, c_1..c_k, y, y^2, y*c_i..., upper-tri c_i*c_j...]."""
    s = y.shape[0]
    k = covars.shape[1]
    cols = [np.ones(s), *(covars[:, i] for i in range(k)), y, y * y]
    cols += [y * covars[:, i] for i in range(k)]
    for i in range(k):
        for j in range(i, k):
            cols.append(covars[:, i] * covars[:, j])
    return np.stack(cols, axis=1)


def glm_moments_numpy(
    packed: np.ndarray,
    num_samples: int,
    y: np.ndarray,
    covars: np.ndarray,
    block_variants: int = 512,
    sample_idx=None,
) -> GlmMoments:
    """Host provider: f64 masked-moment dgemms per block, in-place block
    buffers (first-touch tax — see ROADMAP.md Host IO).

    Block default 512: at 2504 samples the (bv, S) f64 block buffers are
    ~10 MB — cache-resident for the 4-5 elementwise passes per block.
    The old 1<<13 default streamed 165 MB buffers through DRAM every
    pass and measured 10x slower (4.4k vs 46k variants/s, r5)."""
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    ns = num_samples if sample_idx is None else len(sample_idx)
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    if y.shape != (ns,) or covars.shape[0] != ns:
        raise ValueError(
            f"glm: y {y.shape} / covars {covars.shape} do not match "
            f"{ns} samples"
        )
    y, covars = _centered(y, covars)
    pcols = _moment_columns(y, covars)  # (S, P)
    q = np.concatenate([y[:, None], covars], axis=1)  # (S, k+1)
    n = np.empty(nvar, dtype=np.float64)
    mp = np.empty((nvar, pcols.shape[1]), dtype=np.float64)
    gq = np.empty((nvar, q.shape[1]), dtype=np.float64)
    sg = np.empty(nvar, dtype=np.float64)
    sg2 = np.empty(nvar, dtype=np.float64)
    bv = min(block_variants, max(nvar, 1))
    m = np.empty((bv, ns), dtype=np.float64)
    g = np.empty((bv, ns), dtype=np.float64)
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        nb = codes.shape[0]
        mb, gb = m[:nb], g[:nb]
        cal = codes != 3
        np.copyto(mb, cal, casting="unsafe")
        np.copyto(gb, codes, casting="unsafe")
        gb *= cal
        sl = slice(lo, lo + nb)
        n[sl] = mb.sum(axis=1)
        mp[sl] = mb @ pcols
        gq[sl] = gb @ q
        sg[sl] = gb.sum(axis=1)
        gb *= gb
        sg2[sl] = gb.sum(axis=1)
    return GlmMoments(n, mp, gq, sg, sg2)


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _glm_moments_device_jit(
    packed, pcols, q, sel, num_samples, block_variants
):
    """Blocked scan: unpack -> mask/dosage -> f32 moment matmuls.
    Pad rows must be 0xFF (all-missing): every moment is 0."""
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)

    def body(_, blk):
        codes = unpack_codes(blk, num_samples)
        if sel is not None:
            codes = jnp.take(codes, sel, axis=1)
        cal = codes != 3
        mf = cal.astype(jnp.float32)
        g = codes.astype(jnp.float32) * mf
        hi = jax.lax.Precision.HIGHEST
        out = (
            jnp.sum(mf, axis=1),
            jnp.matmul(mf, pcols, preferred_element_type=jnp.float32,
                       precision=hi),
            jnp.matmul(g, q, preferred_element_type=jnp.float32,
                       precision=hi),
            jnp.sum(g, axis=1),
            jnp.sum(g * g, axis=1),
        )
        return None, out

    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    _, outs = jax.lax.scan(body, None, blocks)
    return tuple(
        o.reshape(-1, *o.shape[2:])[:nvar] for o in outs
    )


def glm_moments_device(
    packed,
    num_samples: int,
    y,
    covars,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> GlmMoments:
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    y, covars = _centered(y, covars)
    pcols = _moment_columns(y, covars).astype(np.float32)
    q = np.concatenate([y[:, None], covars], axis=1).astype(np.float32)
    ns = y.shape[0]
    if packed.shape[0] == 0:
        z = np.zeros(0)
        return GlmMoments(z, np.zeros((0, pcols.shape[1])),
                          np.zeros((0, q.shape[1])), z, z)
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)
    outs = _glm_moments_device_jit(
        np.asarray(packed, np.uint8), pcols, q, sel, num_samples,
        block_variants,
    )
    return GlmMoments(*(np.asarray(o, np.float64) for o in outs))


def _native_moment_lib():
    """The native runtime with the sparse moment kernels, or None."""
    try:
        from pgen_tpu.native import HAVE_NATIVE, native
    except ImportError:
        return None
    if not HAVE_NATIVE or not getattr(native, "has_glm_moments", False):
        return None
    return native


def _scatter_cohort(pk, qk, sample_idx, num_samples: int):
    """(keep, pfull, qfull) for the native kernels: full-S row-major
    moment matrices with zero rows for dropped samples + a keep bitmap.
    Returns None for inputs the kernels cannot represent (a duplicated
    sample index means the numpy column-gather counts a sample twice —
    the keep bitmap cannot; fall back rather than silently diverge).
    Shape mismatches raise exactly like the numpy provider."""
    s = num_samples
    n_kept = pk.shape[0]
    if sample_idx is None:
        if n_kept != s:
            raise ValueError(
                f"glm: y/covars hold {n_kept} samples but the pgen "
                f"holds {s}"
            )
        return (
            np.ones(s, dtype=np.uint8),
            np.ascontiguousarray(pk),
            np.ascontiguousarray(qk),
        )
    rows = np.asarray(sample_idx)
    if len(rows) != n_kept:
        raise ValueError(
            f"glm: y/covars hold {n_kept} samples but sample_idx lists "
            f"{len(rows)}"
        )
    if rows.size and (rows.min() < 0 or rows.max() >= s):
        # negative/out-of-range indices: defer to numpy's fancy-index
        # semantics (from-the-end / IndexError) for provider agreement
        return None
    if len(np.unique(rows)) != len(rows):
        return None  # duplicated indices: numpy path semantics required
    keep = np.zeros(s, dtype=np.uint8)
    keep[rows] = 1
    pfull = np.zeros((s, pk.shape[1]))
    qfull = np.zeros((s, qk.shape[1]))
    pfull[rows] = pk
    qfull[rows] = qk
    return keep, pfull, qfull


def glm_moments_native(
    packed, num_samples: int, y, covars, sample_idx=None, **_ignored
) -> GlmMoments | None:
    """C++ sparse-complement provider (pgen_native.cpp pgen_glm_moments):
    only non-hom-ref samples cost work, so realistic (mostly-hom-ref)
    data runs several times faster than the blocked dgemm path. Returns
    None when the native runtime is unavailable (caller falls back)."""
    native = _native_moment_lib()
    if native is None:
        return None
    packed = np.asarray(packed, dtype=np.uint8)
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    yc, cc = _centered(y, covars)
    pk = _moment_columns(yc, cc)  # (n_kept, P)
    qk = np.concatenate([yc[:, None], cc], axis=1)  # (n_kept, k+1)
    scattered = _scatter_cohort(pk, qk, sample_idx, num_samples)
    if scattered is None:
        return None
    keep, pfull, qfull = scattered
    ptot = np.ascontiguousarray(pk.sum(axis=0))
    outs = native.glm_moments(
        packed, keep, pfull, qfull, ptot, float(pk.shape[0]), num_samples
    )
    return GlmMoments(*outs)


def glm_moments(
    packed, num_samples: int, y, covars, provider: str = "numpy", **kw
) -> GlmMoments:
    """Provider dispatch. `native` = the C++ sparse-complement kernel
    (numpy/BLAS fallback when the toolchain is absent); `device` shards
    the variant axis over all local devices when more than one is
    visible (per-variant outputs: embarrassingly parallel)."""
    if provider == "native":
        m = glm_moments_native(packed, num_samples, y, covars,
                               sample_idx=kw.get("sample_idx"))
        if m is not None:
            return m
        provider = "numpy"
    if provider == "device":
        import jax

        from pgen_tpu.pipeline.device import device_backend

        device_backend()

        if len(jax.devices()) > 1:
            return glm_moments_mesh(np.asarray(packed), num_samples, y,
                                    covars, **kw)
        return glm_moments_device(
            np.asarray(packed), num_samples, y, covars,
            **kw,
        )
    return glm_moments_numpy(packed, num_samples, y, covars, **kw)


def glm_moments_mesh(
    packed: np.ndarray,
    num_samples: int,
    y,
    covars,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> GlmMoments:
    """Variant-sharded moments over all local devices. Outputs stay
    variant-sharded (no collective at all — per-variant results)."""
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    nvar = int(packed.shape[0])
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    if nvar == 0:
        return glm_moments_numpy(packed, num_samples, y, covars,
                                 sample_idx=sample_idx)
    mesh = make_mesh()
    padded = pad_to_multiple(np.asarray(packed, dtype=np.uint8),
                             mesh.devices.size)
    if padded.shape[0] != nvar:
        padded[nvar:] = 0xFF  # all-missing pad rows: zero moments
    step = build_glm_mesh_step(
        mesh, num_samples, y, covars, block_variants=block_variants,
        sample_idx=sample_idx,
    )
    outs = step(padded)
    return GlmMoments(*(np.asarray(o, np.float64)[:nvar] for o in outs))


def build_glm_mesh_step(
    mesh, num_samples: int, y, covars, block_variants: int = 1 << 14,
    sample_idx=None,
):
    """Variant-sharded GLM moments: per-shard matmuls, sharded outputs.
    packed (V, R) u8 shards as P('v', None); pad rows must be 0xFF."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgen_tpu.parallel.mesh import VARIANT_AXIS
    from pgen_tpu.pipeline.device import device_backend

    device_backend()
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    y, covars = _centered(y, covars)
    pcols = _moment_columns(y, covars).astype(np.float32)
    q = np.concatenate([y[:, None], covars], axis=1).astype(np.float32)
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)

    def step(packed):
        def inner(packed_l):
            return _glm_moments_device_jit(
                packed_l, pcols, q, sel, num_samples, block_variants,
            )

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None),),
            out_specs=(P(VARIANT_AXIS), P(VARIANT_AXIS, None),
                       P(VARIANT_AXIS, None), P(VARIANT_AXIS),
                       P(VARIANT_AXIS)),
            check_vma=False,
        )(packed)

    in_shardings = (NamedSharding(mesh, P(VARIANT_AXIS, None)),)
    return jax.jit(step, in_shardings=in_shardings)


def glm_solve(moments: GlmMoments, num_covars: int) -> GlmResult:
    """Assemble and solve the per-variant (k+2)-dim normal equations in
    f64; Student-t p-values via the regularized incomplete beta.

    Moment column layout (matches _moment_columns):
      mp[:, 0]            = n        (== moments.n, kept for symmetry)
      mp[:, 1 : 1+k]      = sum c_i
      mp[:, 1+k]          = sum y
      mp[:, 2+k]          = sum y^2
      mp[:, 3+k : 3+2k]   = sum y c_i
      mp[:, 3+2k : ]      = sum c_i c_j  (upper triangle, row-major)
    """
    k = num_covars
    n = moments.n
    nvar = n.shape[0]
    d = k + 2  # [1, c_1..c_k, g]
    a = np.zeros((nvar, d, d), dtype=np.float64)
    rhs = np.zeros((nvar, d, 2), dtype=np.float64)  # [X^T y | e_g]
    mp, gq, sg, sg2 = moments.mp, moments.gq, moments.sg, moments.sg2
    sc = mp[:, 1 : 1 + k]
    sy = mp[:, 1 + k]
    syy = mp[:, 2 + k]
    syc = mp[:, 3 + k : 3 + 2 * k]
    a[:, 0, 0] = n
    a[:, 0, 1 : 1 + k] = sc
    a[:, 1 : 1 + k, 0] = sc
    pos = 3 + 2 * k
    for i in range(k):
        for j in range(i, k):
            a[:, 1 + i, 1 + j] = mp[:, pos]
            a[:, 1 + j, 1 + i] = mp[:, pos]
            pos += 1
    a[:, 0, d - 1] = sg
    a[:, d - 1, 0] = sg
    a[:, 1 : 1 + k, d - 1] = gq[:, 1:].reshape(nvar, k)
    a[:, d - 1, 1 : 1 + k] = gq[:, 1:].reshape(nvar, k)
    a[:, d - 1, d - 1] = sg2
    rhs[:, 0, 0] = sy
    rhs[:, 1 : 1 + k, 0] = syc
    rhs[:, d - 1, 0] = gq[:, 0]
    rhs[:, d - 1, 1] = 1.0

    df = n - d
    # estimable gate: enough complete cases + complete-case dosage variance
    with np.errstate(invalid="ignore", divide="ignore"):
        gvar = sg2 - np.where(n > 0, sg * sg / np.maximum(n, 1), 0.0)
    ok = (df >= 1) & (gvar > 1e-9 * np.maximum(n, 1))
    beta = np.full(nvar, np.nan)
    se = np.full(nvar, np.nan)
    t = np.full(nvar, np.nan)
    p = np.full(nvar, np.nan)
    idx = np.flatnonzero(ok)
    if idx.size:
        try:
            sol = np.linalg.solve(a[idx], rhs[idx])
        except np.linalg.LinAlgError:
            sol = np.full((idx.size, d, 2), np.nan)
            for r, v in enumerate(idx):
                try:
                    sol[r] = np.linalg.solve(a[v], rhs[v])
                except np.linalg.LinAlgError:
                    ok[v] = False
        coefs, zg = sol[..., 0], sol[..., 1]
        bsel = coefs[:, d - 1]
        # residual SS = y'y - beta' X'y;  Var(beta_g) = sigma^2 (A^-1)_gg
        rss = syy[idx] - np.einsum("vi,vi->v", coefs, rhs[idx, :, 0])
        rss = np.maximum(rss, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma2 = rss / df[idx]
            var_g = sigma2 * zg[:, d - 1]
            s = np.sqrt(var_g)
            tt = bsel / s
            pp = t_sf2(tt, df[idx])
        # s > 0 NA's exact fits (rss == 0 -> SE 0, T inf) like plink2
        good = ok[idx] & np.isfinite(s) & (s > 0) & (zg[:, d - 1] > 0)
        beta[idx] = np.where(good, bsel, np.nan)
        se[idx] = np.where(good, s, np.nan)
        t[idx] = np.where(good, tt, np.nan)
        p[idx] = np.where(good, pp, np.nan)
    return GlmResult(n.astype(np.int64), beta, se, t, p)


def glm_linear(
    packed, num_samples: int, y, covars, provider: str = "numpy", **kw
) -> GlmResult:
    """Full per-variant OLS: moments on the chosen provider, batched
    f64 solve + t-test on host."""
    y = np.asarray(y, dtype=np.float64)
    covars = (
        np.zeros((y.shape[0], 0)) if covars is None
        else np.asarray(covars, dtype=np.float64)
    )
    if covars.ndim != 2 or covars.shape[0] != y.shape[0]:
        raise ValueError(f"glm: covars must be (S, k), got {covars.shape}")
    m = glm_moments(packed, num_samples, y, covars, provider=provider, **kw)
    return glm_solve(m, covars.shape[1])


# ---- model modifiers: dominant / recessive / genotypic / hethom ----
#
# plink2 `--glm genotypic|hethom|dominant|recessive` analogs. Every
# modified design's genotype columns are linear combinations of the HET
# (g==1) and HOM-ALT (g==2) indicator columns, and indicators satisfy
# het^2 = het, hom^2 = hom, het*hom = 0 — so ONE extra masked-moment
# block pair (HET @ q2, HOM @ q2 with q2 = [1, y, C]) supplies every
# normal-equation entry of every modifier, including the 2-df designs.
# The (het, hom) weights per genotype column:

MODIFIER_COLS = {
    "dominant": ((1.0, 1.0),),              # DOM  = 1{g >= 1}
    "recessive": ((0.0, 1.0),),             # REC  = 1{g == 2}
    "genotypic": ((1.0, 2.0), (1.0, 0.0)),  # ADD  + DOMDEV (het)
    "hethom": ((0.0, 1.0), (1.0, 0.0)),     # HOM  + HET
}
MODIFIER_TESTS = {
    "dominant": ("DOM",),
    "recessive": ("REC",),
    "genotypic": ("ADD", "DOMDEV"),
    "hethom": ("HOM", "HET"),
}
JOINT_TEST_NAME = "GENO_2DF"


def _geno_moment_inputs(y, covars, dtype=np.float64):
    """Shared preamble for every geno-moments provider: centered y/C,
    the M-block moment columns, and the het/hom-block columns
    q2 = [1, y, C]. The q2 LAYOUT is load-bearing — glm_solve_modifier
    indexes hetq/homq as [:,0]=sum, [:,1]=*y, [:,2:]=@C."""
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    yc, cc = _centered(y, covars)
    pcols = _moment_columns(yc, cc).astype(dtype)
    q2 = np.concatenate(
        [np.ones((yc.shape[0], 1)), yc[:, None], cc], axis=1
    ).astype(dtype)
    return pcols, q2


class GlmGenoMoments(NamedTuple):
    """Indicator-decomposed per-variant moments (f64, host-side).

    q2 layout: [1, y, c_1..c_k] so hetq[:, 0] = sum het,
    hetq[:, 1] = sum het*y, hetq[:, 2:] = het @ C (same for homq)."""

    n: np.ndarray    # (V,) called count
    mp: np.ndarray   # (V, P) masked sums M @ moment columns
    hetq: np.ndarray  # (V, k+2) het-indicator sums
    homq: np.ndarray  # (V, k+2) hom-indicator sums


class GlmModResult(NamedTuple):
    """Per-variant modifier fit; test axis follows MODIFIER_TESTS."""

    n_obs: np.ndarray    # (V,) i64
    beta: np.ndarray     # (V, T) f64, NaN where unestimable
    se: np.ndarray       # (V, T)
    t_stat: np.ndarray   # (V, T)
    p: np.ndarray        # (V, T)
    joint_stat: np.ndarray | None  # (V,) F statistic (2-df designs)
    joint_p: np.ndarray | None     # (V,)


def glm_geno_moments_numpy(
    packed: np.ndarray,
    num_samples: int,
    y: np.ndarray,
    covars: np.ndarray,
    block_variants: int = 512,
    sample_idx=None,
) -> GlmGenoMoments:
    """Host provider: three f64 dgemms per block (M/HET/HOM).
    Cache-resident block default — see glm_moments_numpy."""
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    pcols, q2 = _geno_moment_inputs(y, covars)
    n = np.empty(nvar, dtype=np.float64)
    mp = np.empty((nvar, pcols.shape[1]), dtype=np.float64)
    hetq = np.empty((nvar, q2.shape[1]), dtype=np.float64)
    homq = np.empty((nvar, q2.shape[1]), dtype=np.float64)
    bv = min(block_variants, max(nvar, 1))
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        sl = slice(lo, lo + codes.shape[0])
        m = (codes != 3).astype(np.float64)
        het = (codes == 1).astype(np.float64)
        hom = (codes == 2).astype(np.float64)
        n[sl] = m.sum(axis=1)
        mp[sl] = m @ pcols
        hetq[sl] = het @ q2
        homq[sl] = hom @ q2
    return GlmGenoMoments(n, mp, hetq, homq)


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _glm_geno_moments_device_jit(
    packed, pcols, q2, sel, num_samples, block_variants
):
    """Blocked scan: unpack -> three f32 moment matmuls (M/HET/HOM).
    Pad rows must be 0xFF (all-missing): every moment is 0."""
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)

    def body(_, blk):
        codes = unpack_codes(blk, num_samples)
        if sel is not None:
            codes = jnp.take(codes, sel, axis=1)
        mf = (codes != 3).astype(jnp.float32)
        het = (codes == 1).astype(jnp.float32)
        hom = (codes == 2).astype(jnp.float32)
        hi = jax.lax.Precision.HIGHEST
        mm = functools.partial(
            jnp.matmul, preferred_element_type=jnp.float32, precision=hi
        )
        return None, (
            jnp.sum(mf, axis=1), mm(mf, pcols), mm(het, q2), mm(hom, q2)
        )

    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    _, outs = jax.lax.scan(body, None, blocks)
    return tuple(o.reshape(-1, *o.shape[2:])[:nvar] for o in outs)


def glm_geno_moments_mesh(
    packed: np.ndarray,
    num_samples: int,
    y,
    covars,
    block_variants: int = 1 << 14,
    sample_idx=None,
) -> GlmGenoMoments:
    """Variant-sharded indicator moments over all local devices (same
    collective-free structure as glm_moments_mesh: per-variant outputs)."""
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    nvar = int(packed.shape[0])
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    if nvar == 0:
        return glm_geno_moments_numpy(packed, num_samples, y, covars,
                                      sample_idx=sample_idx)
    mesh = make_mesh()
    padded = pad_to_multiple(np.asarray(packed, dtype=np.uint8),
                             mesh.devices.size)
    if padded.shape[0] != nvar:
        padded[nvar:] = 0xFF  # all-missing pad rows: zero moments
    step = build_glm_geno_mesh_step(
        mesh, num_samples, y, covars, block_variants=block_variants,
        sample_idx=sample_idx,
    )
    outs = step(padded)
    return GlmGenoMoments(*(np.asarray(o, np.float64)[:nvar] for o in outs))


def build_glm_geno_mesh_step(
    mesh, num_samples: int, y, covars, block_variants: int = 1 << 14,
    sample_idx=None,
):
    """Variant-sharded modifier (het/hom indicator) moments: per-shard
    matmuls, sharded outputs. packed (V, R) u8 shards as P('v', None);
    pad rows must be 0xFF."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgen_tpu.parallel.mesh import VARIANT_AXIS
    from pgen_tpu.pipeline.device import device_backend

    device_backend()
    pcols, q2 = _geno_moment_inputs(y, covars, dtype=np.float32)
    sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)

    def step(packed):
        def inner(packed_l):
            return _glm_geno_moments_device_jit(
                packed_l, pcols, q2, sel, num_samples, block_variants,
            )

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None),),
            out_specs=(P(VARIANT_AXIS), P(VARIANT_AXIS, None),
                       P(VARIANT_AXIS, None), P(VARIANT_AXIS, None)),
            check_vma=False,
        )(packed)

    in_shardings = (NamedSharding(mesh, P(VARIANT_AXIS, None)),)
    return jax.jit(step, in_shardings=in_shardings)


def glm_geno_moments_native(
    packed, num_samples: int, y, covars, sample_idx=None
) -> GlmGenoMoments | None:
    """C++ sparse-complement modifier moments (pgen_glm_geno_moments);
    None when the native runtime is unavailable."""
    native = _native_moment_lib()
    if native is None or not getattr(native, "has_geno_moments", False):
        return None
    packed = np.asarray(packed, dtype=np.uint8)
    pk, qk = _geno_moment_inputs(y, covars)
    scattered = _scatter_cohort(pk, qk, sample_idx, num_samples)
    if scattered is None:
        return None
    keep, pfull, qfull = scattered
    ptot = np.ascontiguousarray(pk.sum(axis=0))
    outs = native.glm_geno_moments(
        packed, keep, pfull, qfull, ptot, float(pk.shape[0]), num_samples
    )
    return GlmGenoMoments(*outs)


def glm_geno_moments(
    packed, num_samples: int, y, covars, provider: str = "numpy",
    block_variants: int | None = None, sample_idx=None,
) -> GlmGenoMoments:
    """Provider dispatch for the indicator moments. `native` = the C++
    sparse-complement kernel (numpy fallback); `device` shards the
    variant axis over all local devices when more than one is visible.
    block_variants None = provider-appropriate default (device scans
    want big HBM-resident blocks; host wants cache-resident ones)."""
    if provider == "native":
        m = glm_geno_moments_native(packed, num_samples, y, covars,
                                    sample_idx=sample_idx)
        if m is not None:
            return m
        provider = "numpy"
    if provider == "device":
        import jax as _jax

        bv = 1 << 14 if block_variants is None else int(block_variants)
        if len(_jax.devices()) > 1 and packed.shape[0] > 0:
            return glm_geno_moments_mesh(
                np.asarray(packed), num_samples, y, covars,
                block_variants=bv, sample_idx=sample_idx,
            )
        from pgen_tpu.pipeline.device import device_backend

        device_backend()

        pcols, q2 = _geno_moment_inputs(y, covars, dtype=np.float32)
        if packed.shape[0] == 0:
            z = np.zeros(0)
            return GlmGenoMoments(
                z, np.zeros((0, pcols.shape[1])),
                np.zeros((0, q2.shape[1])), np.zeros((0, q2.shape[1])),
            )
        sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)
        outs = _glm_geno_moments_device_jit(
            np.asarray(packed, np.uint8), pcols, q2, sel, num_samples,
            bv,
        )
        return GlmGenoMoments(*(np.asarray(o, np.float64) for o in outs))
    return glm_geno_moments_numpy(
        packed, num_samples, y, covars,
        block_variants=512 if block_variants is None else int(block_variants),
        sample_idx=sample_idx,
    )


def glm_solve_modifier(
    moments: GlmGenoMoments, num_covars: int, modifier: str
) -> GlmModResult:
    """Assemble and solve the per-variant modified-design normal
    equations in f64 ([1, C, g_1(, g_2)]); for the 2-df designs also
    run the covariate-only fit per variant and report the joint F test
    (plink2 GENO_2DF)."""
    cols = MODIFIER_COLS[modifier]
    k = num_covars
    nt = len(cols)
    d = k + 1 + nt
    n = moments.n
    nvar = n.shape[0]
    mp, hetq, homq = moments.mp, moments.hetq, moments.homq
    sc = mp[:, 1 : 1 + k]
    sy = mp[:, 1 + k]
    syy = mp[:, 2 + k]
    syc = mp[:, 3 + k : 3 + 2 * k]
    sh, sho = hetq[:, 0], homq[:, 0]
    a = np.zeros((nvar, d, d), dtype=np.float64)
    rhs = np.zeros((nvar, d, 1 + nt), dtype=np.float64)
    a[:, 0, 0] = n
    a[:, 0, 1 : 1 + k] = sc
    a[:, 1 : 1 + k, 0] = sc
    pos = 3 + 2 * k
    for i in range(k):
        for j in range(i, k):
            a[:, 1 + i, 1 + j] = mp[:, pos]
            a[:, 1 + j, 1 + i] = mp[:, pos]
            pos += 1
    rhs[:, 0, 0] = sy
    rhs[:, 1 : 1 + k, 0] = syc
    gsum = []
    for t, (a1, a2) in enumerate(cols):
        j = k + 1 + t
        sg_t = a1 * sh + a2 * sho
        gsum.append(sg_t)
        a[:, 0, j] = sg_t
        a[:, j, 0] = sg_t
        gc_t = a1 * hetq[:, 2:] + a2 * homq[:, 2:]
        a[:, 1 : 1 + k, j] = gc_t
        a[:, j, 1 : 1 + k] = gc_t
        rhs[:, j, 0] = a1 * hetq[:, 1] + a2 * homq[:, 1]
        rhs[:, j, 1 + t] = 1.0
        for u, (b1, b2) in enumerate(cols):
            # indicator algebra: het*hom == 0, het^2 == het, hom^2 == hom
            a[:, j, k + 1 + u] = a1 * b1 * sh + a2 * b2 * sho

    df = n - d
    ok = df >= 1
    # each genotype column needs complete-case variance
    with np.errstate(invalid="ignore", divide="ignore"):
        for t, (a1, a2) in enumerate(cols):
            sq_t = a1 * a1 * sh + a2 * a2 * sho
            gv = sq_t - np.where(n > 0, gsum[t] ** 2 / np.maximum(n, 1), 0.0)
            ok &= gv > 1e-9 * np.maximum(n, 1)
    if nt == 2:
        # non-collinear columns (e.g. no hom-ref calls makes ADD ~ const
        # + DOMDEV): Gram determinant of the centered pair
        with np.errstate(invalid="ignore", divide="ignore"):
            c00 = a[:, k + 1, k + 1] - gsum[0] ** 2 / np.maximum(n, 1)
            c11 = a[:, k + 2, k + 2] - gsum[1] ** 2 / np.maximum(n, 1)
            c01 = a[:, k + 1, k + 2] - gsum[0] * gsum[1] / np.maximum(n, 1)
        ok &= (c00 * c11 - c01 * c01) > 1e-9 * np.maximum(n, 1)
    beta = np.full((nvar, nt), np.nan)
    se = np.full((nvar, nt), np.nan)
    tt_out = np.full((nvar, nt), np.nan)
    p = np.full((nvar, nt), np.nan)
    joint_f = np.full(nvar, np.nan) if nt == 2 else None
    joint_p = np.full(nvar, np.nan) if nt == 2 else None
    idx = np.flatnonzero(ok)
    if idx.size:
        try:
            sol = np.linalg.solve(a[idx], rhs[idx])
        except np.linalg.LinAlgError:
            sol = np.full((idx.size, d, 1 + nt), np.nan)
            for r, v in enumerate(idx):
                try:
                    sol[r] = np.linalg.solve(a[v], rhs[v])
                except np.linalg.LinAlgError:
                    ok[v] = False
        coefs = sol[..., 0]
        rss = syy[idx] - np.einsum("vi,vi->v", coefs, rhs[idx, :, 0])
        rss = np.maximum(rss, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma2 = rss / df[idx]
            for t in range(nt):
                j = k + 1 + t
                zjj = sol[:, j, 1 + t]
                b = coefs[:, j]
                s = np.sqrt(sigma2 * zjj)
                tv = b / s
                pv = t_sf2(tv, df[idx])
                good = ok[idx] & np.isfinite(s) & (s > 0) & (zjj > 0)
                beta[idx, t] = np.where(good, b, np.nan)
                se[idx, t] = np.where(good, s, np.nan)
                tt_out[idx, t] = np.where(good, tv, np.nan)
                p[idx, t] = np.where(good, pv, np.nan)
        if nt == 2:
            # covariate-only RSS for the joint 2-df F test
            d0 = k + 1
            a0 = a[idx][:, :d0, :d0]
            r0 = rhs[idx][:, :d0, :1]
            try:
                sol0 = np.linalg.solve(a0, r0)[..., 0]
            except np.linalg.LinAlgError:
                sol0 = np.full((idx.size, d0), np.nan)
                for r in range(idx.size):
                    try:
                        sol0[r] = np.linalg.solve(a0[r], r0[r, :, 0])
                    except np.linalg.LinAlgError:
                        pass
            rss0 = syy[idx] - np.einsum("vi,vi->v", sol0, r0[..., 0])
            rss0 = np.maximum(rss0, 0.0)
            with np.errstate(invalid="ignore", divide="ignore"):
                f = ((rss0 - rss) / 2.0) / sigma2
                f = np.maximum(f, 0.0)
                x = df[idx] / (df[idx] + 2.0 * f)
                pj = np.asarray(betainc_reg(df[idx] / 2.0, 1.0, x))
            good = ok[idx] & np.isfinite(f) & (sigma2 > 0)
            joint_f[idx] = np.where(good, f, np.nan)
            joint_p[idx] = np.where(good, pj, np.nan)
    return GlmModResult(
        n.astype(np.int64), beta, se, tt_out, p, joint_f, joint_p
    )


def glm_linear_modifier(
    packed, num_samples: int, y, covars, modifier: str,
    provider: str = "numpy", **kw
) -> GlmModResult:
    """Full per-variant modified-design OLS (plink2 --glm
    genotypic/hethom/dominant/recessive, linear model)."""
    if modifier not in MODIFIER_COLS:
        raise ValueError(f"glm: unknown modifier {modifier!r}")
    y = np.asarray(y, dtype=np.float64)
    covars = (
        np.zeros((y.shape[0], 0)) if covars is None
        else np.asarray(covars, dtype=np.float64)
    )
    m = glm_geno_moments(
        packed, num_samples, y, covars, provider=provider, **kw
    )
    return glm_solve_modifier(m, covars.shape[1], modifier)


# ---- interaction model: [1, C, g, g*C] (plink2 --glm interaction) ----


class GlmIntMoments(NamedTuple):
    """Per-variant complete-case moments for the interaction design.

    Three (V, P) masked-moment blocks over the SAME column set P =
    _moment_columns(y, covars) = [1, c, y, y^2, y*c, c_i*c_j]:
      mp  = M  @ P   (mask-weighted sums)
      gp  = G  @ P   (dosage-weighted)
      g2p = G^2 @ P  (dosage^2-weighted)
    Together these hold every entry of the (2k+2)-dim normal equations —
    one extra gemm per block vs the plain model."""

    n: np.ndarray
    mp: np.ndarray
    gp: np.ndarray
    g2p: np.ndarray


class GlmIntResult(NamedTuple):
    """Per-variant, per-test arrays; test axis = [ADD, ADDxC1..ADDxCk]."""

    n_obs: np.ndarray   # (V,) i64
    beta: np.ndarray    # (V, 1+k) f64, NaN where unestimable
    se: np.ndarray      # (V, 1+k)
    t_stat: np.ndarray  # (V, 1+k)
    p: np.ndarray       # (V, 1+k)


def glm_int_moments_numpy(
    packed: np.ndarray,
    num_samples: int,
    y: np.ndarray,
    covars: np.ndarray,
    block_variants: int = 512,
    sample_idx=None,
) -> GlmIntMoments:
    """Host provider: three f64 dgemms per block (M/G/G^2 @ P).
    Cache-resident block default — see glm_moments_numpy."""
    from pgen_tpu.ops.unpack_host import unpack_codes_numpy

    packed = np.asarray(packed, dtype=np.uint8)
    nvar = packed.shape[0]
    ns = num_samples if sample_idx is None else len(sample_idx)
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    y, covars = _centered(y, covars)
    pcols = _moment_columns(y, covars)  # (S, P)
    np_ = pcols.shape[1]
    n = np.empty(nvar, dtype=np.float64)
    mp = np.empty((nvar, np_), dtype=np.float64)
    gp = np.empty((nvar, np_), dtype=np.float64)
    g2p = np.empty((nvar, np_), dtype=np.float64)
    bv = min(block_variants, max(nvar, 1))
    m = np.empty((bv, ns), dtype=np.float64)
    g = np.empty((bv, ns), dtype=np.float64)
    for lo in range(0, nvar, bv):
        codes = unpack_codes_numpy(packed[lo : lo + bv], num_samples)
        if sample_idx is not None:
            codes = codes[:, sample_idx]
        nb = codes.shape[0]
        mb, gb = m[:nb], g[:nb]
        cal = codes != 3
        np.copyto(mb, cal, casting="unsafe")
        np.copyto(gb, codes, casting="unsafe")
        gb *= cal
        sl = slice(lo, lo + nb)
        n[sl] = mb.sum(axis=1)
        mp[sl] = mb @ pcols
        gp[sl] = gb @ pcols
        gb *= gb
        g2p[sl] = gb @ pcols
    return GlmIntMoments(n, mp, gp, g2p)


@functools.partial(
    jax.jit, static_argnames=("num_samples", "block_variants")
)
def _glm_int_moments_device_jit(
    packed, pcols, sel, num_samples, block_variants
):
    """Blocked scan: unpack -> three f32 moment matmuls (M/G/G^2 @ P).
    Pad rows must be 0xFF (all-missing): every moment is 0."""
    import jax.numpy as jnp

    from pgen_tpu.ops.unpack import unpack_codes

    nvar = packed.shape[0]
    nblk = max(1, -(-nvar // block_variants))
    pad = nblk * block_variants - nvar
    packed = jnp.pad(packed, ((0, pad), (0, 0)), constant_values=0xFF)

    def body(_, blk):
        codes = unpack_codes(blk, num_samples)
        if sel is not None:
            codes = jnp.take(codes, sel, axis=1)
        cal = codes != 3
        mf = cal.astype(jnp.float32)
        g = codes.astype(jnp.float32) * mf
        hi = jax.lax.Precision.HIGHEST
        mm = functools.partial(
            jnp.matmul, preferred_element_type=jnp.float32, precision=hi
        )
        out = (
            jnp.sum(mf, axis=1),
            mm(mf, pcols),
            mm(g, pcols),
            mm(g * g, pcols),
        )
        return None, out

    blocks = packed.reshape(nblk, block_variants, packed.shape[1])
    _, outs = jax.lax.scan(body, None, blocks)
    return tuple(o.reshape(-1, *o.shape[2:])[:nvar] for o in outs)


def glm_int_moments(
    packed, num_samples: int, y, covars, provider: str = "numpy",
    block_variants: int | None = None, sample_idx=None,
) -> GlmIntMoments:
    """Provider dispatch (`native` -> numpy; `device` = single-device
    scan — per-variant outputs are embarrassingly parallel, so chunk
    externally for pod-scale fan-out)."""
    if provider == "device":
        from pgen_tpu.pipeline.device import device_backend

        device_backend()

        y64 = np.asarray(y, dtype=np.float64)
        c64 = np.asarray(covars, dtype=np.float64)
        yc, cc = _centered(y64, c64)
        pcols = _moment_columns(yc, cc).astype(np.float32)
        if packed.shape[0] == 0:
            z = np.zeros(0)
            zp = np.zeros((0, pcols.shape[1]))
            return GlmIntMoments(z, zp, zp.copy(), zp.copy())
        sel = None if sample_idx is None else np.asarray(sample_idx, np.int32)
        outs = _glm_int_moments_device_jit(
            np.asarray(packed, np.uint8), pcols, sel, num_samples,
            1 << 14 if block_variants is None else int(block_variants),
        )
        return GlmIntMoments(*(np.asarray(o, np.float64) for o in outs))
    return glm_int_moments_numpy(
        packed, num_samples, y, covars,
        block_variants=512 if block_variants is None else int(block_variants),
        sample_idx=sample_idx,
    )


def glm_solve_interaction(
    moments: GlmIntMoments, num_covars: int, covar_means=None
) -> GlmIntResult:
    """Assemble and solve the per-variant (2k+2)-dim normal equations
    for the design [1, c_1..c_k, g, g*c_1..g*c_k]; report each dosage
    term (ADD and every ADDxC_i) with its own SE / t / p.

    covar_means: the cohort means subtracted by _centered() before the
    moments were built. Centering c changes the ADD coefficient's
    MEANING (g*(c - m) = g*c - m*g, and g is in the design, so the fit
    is identical but beta_g shifts by sum_i m_i * beta_gci); plink2
    reports the RAW parameterization, so ADD's beta and SE are
    recovered through the linear map w = e_g - sum_i m_i e_gci using
    the already-solved A^-1 unit columns (interaction coefficients and
    their SEs are invariant to the shift). Pass None when the moments
    were built from already-raw covariates."""
    k = num_covars
    n = moments.n
    nvar = n.shape[0]
    d = 2 * k + 2
    ntest = k + 1

    # P-column index helpers (layout of _moment_columns)
    def ic(i):
        return 1 + i

    iy = k + 1
    iyy = k + 2

    def iyc(i):
        return k + 3 + i

    def icc(i, j):
        if i > j:
            i, j = j, i
        return 2 * k + 3 + i * k - i * (i - 1) // 2 + (j - i)

    mp, gp, g2p = moments.mp, moments.gp, moments.g2p
    a = np.zeros((nvar, d, d), dtype=np.float64)
    rhs = np.zeros((nvar, d, 1 + ntest), dtype=np.float64)
    a[:, 0, 0] = n
    a[:, 0, k + 1] = gp[:, 0]
    a[:, k + 1, k + 1] = g2p[:, 0]
    rhs[:, 0, 0] = mp[:, iy]
    rhs[:, k + 1, 0] = gp[:, iy]
    for i in range(k):
        a[:, 0, 1 + i] = mp[:, ic(i)]
        a[:, 0, k + 2 + i] = gp[:, ic(i)]
        a[:, 1 + i, k + 1] = gp[:, ic(i)]
        a[:, k + 1, k + 2 + i] = g2p[:, ic(i)]
        rhs[:, 1 + i, 0] = mp[:, iyc(i)]
        rhs[:, k + 2 + i, 0] = gp[:, iyc(i)]
        for j in range(k):
            if j >= i:
                a[:, 1 + i, 1 + j] = mp[:, icc(i, j)]
                a[:, k + 2 + i, k + 2 + j] = g2p[:, icc(i, j)]
            a[:, 1 + i, k + 2 + j] = gp[:, icc(i, j)]
    # symmetrize: only the upper triangle + diagonal were filled, so add
    # the transpose with its diagonal zeroed (entries can be negative —
    # covariates are centered — so an elementwise max would be wrong)
    at = np.transpose(a, (0, 2, 1)).copy()
    di = np.arange(d)
    at[:, di, di] = 0.0
    a = a + at
    # unit columns select the tested coefficients' (A^-1)_jj
    for t in range(ntest):
        rhs[:, k + 1 + t, 1 + t] = 1.0

    df = n - d
    sg, sg2 = gp[:, 0], g2p[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        gvar = sg2 - np.where(n > 0, sg * sg / np.maximum(n, 1), 0.0)
    ok = (df >= 1) & (gvar > 1e-9 * np.maximum(n, 1))
    beta = np.full((nvar, ntest), np.nan)
    se = np.full((nvar, ntest), np.nan)
    tt_out = np.full((nvar, ntest), np.nan)
    p = np.full((nvar, ntest), np.nan)
    idx = np.flatnonzero(ok)
    if idx.size:
        try:
            sol = np.linalg.solve(a[idx], rhs[idx])
        except np.linalg.LinAlgError:
            sol = np.full((idx.size, d, 1 + ntest), np.nan)
            for r, v in enumerate(idx):
                try:
                    sol[r] = np.linalg.solve(a[v], rhs[v])
                except np.linalg.LinAlgError:
                    ok[v] = False
        coefs = sol[..., 0]
        rss = mp[idx, iyy] - np.einsum("vi,vi->v", coefs, rhs[idx, :, 0])
        rss = np.maximum(rss, 0.0)
        means = (
            np.zeros(k) if covar_means is None
            else np.asarray(covar_means, dtype=np.float64)
        )
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma2 = rss / df[idx]
            for t in range(ntest):
                j = k + 1 + t
                if t == 0 and means.any():
                    # raw-parameterization ADD: beta_raw = w' beta,
                    # var = sigma^2 * w' A^-1 w with
                    # w = e_g - sum_i m_i e_gci
                    acol = sol[:, :, 1].copy()  # A^-1 e_g
                    for i in range(k):
                        acol -= means[i] * sol[:, :, 2 + i]
                    zjj = acol[:, k + 1].copy()
                    b = coefs[:, k + 1].copy()
                    for i in range(k):
                        zjj -= means[i] * acol[:, k + 2 + i]
                        b -= means[i] * coefs[:, k + 2 + i]
                else:
                    zjj = sol[:, j, 1 + t]
                    b = coefs[:, j]
                s = np.sqrt(sigma2 * zjj)
                tv = b / s
                pv = t_sf2(tv, df[idx])
                good = ok[idx] & np.isfinite(s) & (s > 0) & (zjj > 0)
                beta[idx, t] = np.where(good, b, np.nan)
                se[idx, t] = np.where(good, s, np.nan)
                tt_out[idx, t] = np.where(good, tv, np.nan)
                p[idx, t] = np.where(good, pv, np.nan)
    return GlmIntResult(n.astype(np.int64), beta, se, tt_out, p)


def glm_linear_interaction(
    packed, num_samples: int, y, covars, provider: str = "numpy", **kw
) -> GlmIntResult:
    """Full per-variant interaction OLS (plink2 --glm interaction,
    linear): moments on the chosen provider, batched f64 solves."""
    y = np.asarray(y, dtype=np.float64)
    covars = np.asarray(covars, dtype=np.float64)
    if covars.ndim != 2 or covars.shape[0] != y.shape[0]:
        raise ValueError(f"glm: covars must be (S, k), got {covars.shape}")
    if covars.shape[1] == 0:
        raise ValueError(
            "glm --interaction needs at least one covariate (the "
            "interaction terms are dosage x covariate)"
        )
    m = glm_int_moments(packed, num_samples, y, covars, provider=provider, **kw)
    return glm_solve_interaction(
        m, covars.shape[1], covar_means=covars.mean(axis=0)
    )


# ---- Student-t survival function (exact, f64, no scipy dependency) ----

# Lanczos g=7, n=9 coefficients (Boost/GSL-standard; ~1e-15 relative)
_LANCZOS = np.array([
    0.99999999999980993, 676.5203681218851, -1259.1392167224028,
    771.32342877765313, -176.61502916214059, 12.507343278686905,
    -0.13857109526572012, 9.9843695780195716e-6, 1.5056327351493116e-7,
])


def _lgamma(z):
    """Vectorized log-gamma for z > 0 (Lanczos approximation, f64)."""
    z = np.asarray(z, dtype=np.float64)
    zm1 = z - 1.0
    x = np.full(z.shape, _LANCZOS[0])
    for i in range(1, 9):
        x = x + _LANCZOS[i] / (zm1 + i)
    t = zm1 + 7.5
    return 0.5 * np.log(2.0 * np.pi) + (zm1 + 0.5) * np.log(t) - t + np.log(x)


def betainc_reg(a, b, x, max_iter: int = 300, eps: float = 3e-16):
    """Regularized incomplete beta I_x(a, b), vectorized f64.

    Continued fraction (Lentz), with the standard symmetry switch at
    x > (a+1)/(a+b+2) for convergence. Matches jax.scipy.special.betainc
    to ~1e-14 (asserted in tests)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    a, b, x = np.broadcast_arrays(a, b, x)
    out = np.empty(x.shape, dtype=np.float64)
    flat_a, flat_b, flat_x = a.ravel(), b.ravel(), x.ravel()
    res = np.empty(flat_x.shape)
    lo = flat_x <= 0
    hi = flat_x >= 1
    res[lo] = 0.0
    res[hi] = 1.0
    mid = ~(lo | hi)
    if mid.any():
        aa, bb, xx = flat_a[mid], flat_b[mid], flat_x[mid]
        swap = xx > (aa + 1.0) / (aa + bb + 2.0)
        a_ = np.where(swap, bb, aa)
        b_ = np.where(swap, aa, bb)
        x_ = np.where(swap, 1.0 - xx, xx)
        front = np.exp(
            _lgamma(a_ + b_) - _lgamma(a_) - _lgamma(b_)
            + a_ * np.log(x_) + b_ * np.log1p(-x_)
        ) / a_
        # Lentz's algorithm, active-set compressed: converged elements are
        # retired each iteration so the per-iteration work tracks only the
        # slow tail (most entries converge in << max_iter iterations)
        tiny = 1e-300
        c = np.ones_like(x_)
        d = 1.0 - (a_ + b_) * x_ / (a_ + 1.0)
        d = np.where(np.abs(d) < tiny, tiny, d)
        d = 1.0 / d
        h = d.copy()
        h_final = np.empty_like(h)
        idx = np.arange(h.size)
        for m_i in range(1, max_iter + 1):
            m2 = 2 * m_i
            num = m_i * (b_ - m_i) * x_ / ((a_ + m2 - 1.0) * (a_ + m2))
            d = 1.0 + num * d
            d = np.where(np.abs(d) < tiny, tiny, d)
            c = 1.0 + num / c
            c = np.where(np.abs(c) < tiny, tiny, c)
            d = 1.0 / d
            h *= d * c
            num = -(a_ + m_i) * (a_ + b_ + m_i) * x_ / (
                (a_ + m2) * (a_ + m2 + 1.0)
            )
            d = 1.0 + num * d
            d = np.where(np.abs(d) < tiny, tiny, d)
            c = 1.0 + num / c
            c = np.where(np.abs(c) < tiny, tiny, c)
            d = 1.0 / d
            delta = d * c
            h *= delta
            conv = np.abs(delta - 1.0) < eps
            if conv.any():
                h_final[idx[conv]] = h[conv]
                if conv.all():
                    break
                keep = ~conv
                idx, h, c, d = idx[keep], h[keep], c[keep], d[keep]
                a_, b_, x_ = a_[keep], b_[keep], x_[keep]
        else:
            h_final[idx] = h  # unconverged tail: best effort
        val = front * h_final
        res[mid] = np.where(swap, 1.0 - val, val)
    out.ravel()[:] = res
    return out


def t_sf2(t, df):
    """Two-sided Student-t p-value: P(|T_df| >= |t|) =
    I_{df/(df+t^2)}(df/2, 1/2).

    At df >= 1e8 the continued fraction's argument x = df/(df+t^2) sits
    within ~1e-8 of 1 and the Lentz iteration loses ~7 digits, while the
    normal limit's relative error is O(t^4/df) <= ~1e-6 at t <= 100 —
    strictly tighter there, so switch to erfc(|t|/sqrt(2))."""
    t = np.asarray(t, dtype=np.float64)
    df = np.asarray(df, dtype=np.float64)
    x = df / (df + t * t)
    out = np.asarray(betainc_reg(df / 2.0, 0.5, x))
    big = np.broadcast_to(df >= 1e8, out.shape)
    if big.any():
        from pgen_tpu.ops.logistic import normal_sf2

        tb = np.broadcast_to(t, out.shape)
        out = np.where(big, normal_sf2(tb), out)
    return out
