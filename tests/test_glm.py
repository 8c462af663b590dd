"""GLM linear association: providers vs a per-variant lstsq oracle, the
t-distribution tail, planted-effect recovery, mesh sharding, and the CLI
.glm.linear surface."""

import numpy as np
import pytest

from tests.cli_helpers import run_cli
from tests.conftest import build_fileset

from tests.oracle import t_sf2_oracle

from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops.glm import (
    betainc_reg,
    glm_linear,
    glm_moments_device,
    glm_moments_numpy,
    glm_solve,
    t_sf2,
)
from pgen_tpu.pipeline.glm import parse_numeric_column


def _pack(codes: np.ndarray, tmp_path, name="p") -> np.ndarray:
    path = str(tmp_path / f"{name}.pgen")
    write_pgen(path, codes)
    rec = (2 * codes.shape[1] + 7) // 8
    return np.fromfile(path, dtype=np.uint8)[12:].reshape(codes.shape[0], rec)


def _glm_oracle(codes, y, covars):
    """Per-variant complete-case lstsq + classical t-test."""
    nv, _ = codes.shape
    k = covars.shape[1]
    out = []
    for v in range(nv):
        cal = codes[v] != 3
        n = int(cal.sum())
        g = codes[v][cal].astype(np.float64)
        if n < k + 3 or np.var(g) == 0:
            out.append((n, np.nan, np.nan, np.nan, np.nan))
            continue
        x = np.column_stack([np.ones(n), covars[cal], g])
        yy = y[cal]
        coef = np.linalg.lstsq(x, yy, rcond=None)[0]
        resid = yy - x @ coef
        df = n - x.shape[1]
        sigma2 = (resid @ resid) / df
        se = np.sqrt(sigma2 * np.linalg.inv(x.T @ x)[-1, -1])
        t = coef[-1] / se
        # independent mpmath tail — NOT the production t_sf2
        out.append((n, coef[-1], se, t, t_sf2_oracle(t, df)))
    return out


@pytest.mark.parametrize("k", [0, 1, 3])
def test_glm_numpy_matches_oracle(k, tmp_path):
    rng = np.random.default_rng(10 + k)
    nv, ns = 40, 23
    codes = rng.integers(0, 4, size=(nv, ns), dtype=np.uint8)
    codes[0] = 3  # all missing -> NA
    codes[1] = 1  # zero dosage variance -> NA
    y = rng.normal(size=ns)
    covars = rng.normal(size=(ns, k))
    packed = _pack(codes, tmp_path)
    res = glm_linear(packed, ns, y, covars, provider="numpy",
                     block_variants=16)
    for v, (n, b, se, t, p) in enumerate(_glm_oracle(codes, y, covars)):
        assert res.n_obs[v] == n
        if np.isnan(b):
            assert np.isnan(res.beta[v])
            continue
        np.testing.assert_allclose(res.beta[v], b, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(res.se[v], se, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(res.t_stat[v], t, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(res.p[v], p, rtol=1e-8, atol=1e-12)


def test_glm_device_moments_match_numpy(tmp_path):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=(50, 9), dtype=np.uint8)
    y = rng.normal(size=9)
    covars = rng.normal(size=(9, 2))
    packed = _pack(codes, tmp_path)
    ref = glm_moments_numpy(packed, 9, y, covars)
    got = glm_moments_device(packed, 9, y, covars, block_variants=16)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    # end-to-end stats agree at f32-moment precision
    r1 = glm_solve(ref, 2)
    r2 = glm_solve(got, 2)
    np.testing.assert_allclose(r2.beta, r1.beta, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(r2.t_stat, r1.t_stat, rtol=1e-2, atol=1e-3)


def test_glm_sample_subset(tmp_path):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=(30, 10), dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    sel = np.array([0, 2, 3, 5, 6, 7, 8, 9], dtype=np.int32)
    y = rng.normal(size=len(sel))
    covars = rng.normal(size=(len(sel), 1))
    res = glm_linear(packed, 10, y, covars, provider="numpy",
                     sample_idx=sel)
    for v, (n, b, se, t, p) in enumerate(
        _glm_oracle(codes[:, sel], y, covars)
    ):
        assert res.n_obs[v] == n
        if np.isnan(b):
            assert np.isnan(res.beta[v])
        else:
            np.testing.assert_allclose(res.beta[v], b, rtol=1e-9)
            np.testing.assert_allclose(res.t_stat[v], t, rtol=1e-8)


def test_glm_mesh_matches_numpy(tmp_path):
    import jax

    from pgen_tpu.ops.glm import glm_moments_mesh

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(41, 6), dtype=np.uint8)
    y = rng.normal(size=6)
    covars = rng.normal(size=(6, 1))
    packed = _pack(codes, tmp_path)
    assert len(jax.devices()) > 1  # conftest forces the 8-device CPU mesh
    ref = glm_moments_numpy(packed, 6, y, covars)
    got = glm_moments_mesh(packed, 6, y, covars, block_variants=4)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)


def test_glm_recovers_planted_effect():
    rng = np.random.default_rng(7)
    nv, ns = 50, 400
    codes = rng.binomial(2, 0.3, size=(nv, ns)).astype(np.uint8)
    y = 0.9 * codes[17].astype(np.float64) + rng.normal(scale=0.5, size=ns)
    covars = np.zeros((ns, 0))
    res_rows = _glm_oracle(codes, y, covars)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        from pathlib import Path

        packed = _pack(codes, Path(td))
        res = glm_linear(packed, ns, y, covars, provider="numpy")
    assert res.p[17] < 1e-20  # the causal variant dominates
    assert np.nanmin(res.p) == res.p[17]
    np.testing.assert_allclose(res.beta[17], 0.9, atol=0.1)
    assert abs(res.beta[17] - res_rows[17][1]) < 1e-12


def test_t_sf2_known_values():
    # symmetric: t=0 -> p=1; heavier tails than normal at small df
    assert abs(t_sf2(0.0, 10) - 1.0) < 1e-14
    # classic table values: P(|T_1| >= 12.706) = 0.05
    np.testing.assert_allclose(t_sf2(12.706, 1), 0.05, rtol=1e-4)
    np.testing.assert_allclose(t_sf2(2.228, 10), 0.05, rtol=1e-3)
    np.testing.assert_allclose(t_sf2(1.96, 1e9), 0.05, rtol=1e-3)
    # betainc edges and symmetry
    assert betainc_reg(0.5, 0.5, 0.0) == 0.0
    assert betainc_reg(0.5, 0.5, 1.0) == 1.0
    np.testing.assert_allclose(betainc_reg(0.5, 0.5, 0.5), 0.5, rtol=1e-12)
    np.testing.assert_allclose(
        betainc_reg(3.0, 2.0, 0.3) + betainc_reg(2.0, 3.0, 0.7), 1.0,
        rtol=1e-12,
    )


def test_parse_numeric_column():
    got = parse_numeric_column(["1.5", "NA", "-9", "M", "f", "."], "X")
    np.testing.assert_array_equal(
        np.isnan(got), [False, True, True, False, False, True]
    )
    assert got[0] == 1.5 and got[3] == 1.0 and got[4] == 2.0
    with pytest.raises(ValueError, match="not numeric"):
        parse_numeric_column(["zzz"], "X")


def _glm_fileset(tmp_path, codes, pheno, sex=None):
    nvar, ns = codes.shape
    pvar_rows = [f"1\t{100 + i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nvar)]
    sex = sex or ["M" if i % 2 == 0 else "F" for i in range(ns)]
    psam_rows = [f"s{i}\t{sex[i]}\t{pheno[i]}" for i in range(ns)]
    return build_fileset(
        tmp_path, "glm", codes, pvar_rows, psam_rows,
        psam_columns="#IID\tSEX\tPHENO1",
    )


def test_cli_glm_end_to_end(tmp_path):
    rng = np.random.default_rng(11)
    nv, ns = 25, 40
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    codes[3, :7] = 3  # some missingness
    y = rng.normal(size=ns)
    pheno = [f"{v:.8g}" for v in y]
    pheno[5] = "NA"  # one missing phenotype -> dropped sample
    prefix = _glm_fileset(tmp_path, codes, pheno)
    out = str(tmp_path / "out.lin")
    assert run_cli(["glm", prefix, "-o", out, "--covar-name", "SEX"]) == 0
    lines = (tmp_path / "out.lin").read_text().splitlines()
    assert lines[0] == (
        "#CHROM\tPOS\tID\tREF\tALT\tA1\tTEST\tOBS_CT\tBETA\tSE\tT_STAT\tP"
    )
    assert len(lines) == nv + 1
    keep = np.ones(ns, bool)
    keep[5] = False
    sex = np.array([1.0 if i % 2 == 0 else 2.0 for i in range(ns)])
    oracle = _glm_oracle(codes[:, keep], y[keep], sex[keep][:, None])
    for v, line in enumerate(lines[1:]):
        c = line.split("\t")
        assert c[:7] == ["1", str(100 + v), f"rs{v}", "A", "G", "G", "ADD"]
        n, b, se, t, p = oracle[v]
        assert int(c[7]) == n
        if np.isnan(b):
            assert c[8:] == ["NA", "NA", "NA", "NA"]
        else:
            np.testing.assert_allclose(float(c[8]), b, rtol=1e-5)
            np.testing.assert_allclose(float(c[11]), p, rtol=1e-4, atol=0)


def test_cli_glm_provider_parity(tmp_path):
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=(30, 20), dtype=np.uint8)
    y = rng.normal(size=20)
    prefix = _glm_fileset(tmp_path, codes, [f"{v:.8g}" for v in y])
    rows = []
    for prov in ("numpy", "device"):
        out = str(tmp_path / f"{prov}.lin")
        assert run_cli([
            "glm", prefix, "-o", out, "--provider", prov,
            "--include-var", 'POS != "101"',
        ]) == 0
        body = (tmp_path / f"{prov}.lin").read_text().splitlines()[1:]
        assert len(body) == 29  # one variant excluded
        rows.append(body)
    for a, b in zip(*rows):
        ca, cb = a.split("\t"), b.split("\t")
        assert ca[:8] == cb[:8]
        if ca[8] == "NA":
            assert cb[8] == "NA"
        else:
            np.testing.assert_allclose(
                float(cb[8]), float(ca[8]), rtol=1e-3, atol=1e-6
            )


def _logit_oracle(gv, yv, cv):
    """Independent per-variant Newton logistic MLE + Wald SE."""
    n = len(yv)
    x = np.column_stack([np.ones(n), cv, gv])
    b = np.zeros(x.shape[1])
    h = None
    for _ in range(60):
        eta = np.clip(x @ b, -30, 30)
        mu = 1.0 / (1.0 + np.exp(-eta))
        h = x.T @ ((mu * (1 - mu))[:, None] * x)
        step = np.linalg.solve(h, x.T @ (yv - mu))
        b += step
        if np.abs(step).max() < 1e-10:
            break
    se = np.sqrt(np.linalg.inv(h)[-1, -1])
    return b[-1], se


@pytest.mark.parametrize("k", [0, 2])
def test_logistic_matches_oracle(k, tmp_path):
    import math

    from pgen_tpu.ops.logistic import glm_logistic

    rng = np.random.default_rng(30 + k)
    nv, ns = 25, 250
    codes = rng.binomial(2, 0.35, size=(nv, ns)).astype(np.uint8)
    codes[rng.random((nv, ns)) < 0.04] = 3
    codes[0] = 3  # all-missing -> NA
    codes[1] = 2  # zero dosage variance -> NA
    covars = rng.normal(size=(ns, k))
    logit = -0.2 + 0.7 * np.where(codes[5] == 3, 0, codes[5])
    y = (rng.random(ns) < 1.0 / (1.0 + np.exp(-logit))).astype(float)
    packed = _pack(codes, tmp_path)
    res = glm_logistic(packed, ns, y, covars, block_variants=8)
    for v in range(nv):
        cal = codes[v] != 3
        g = codes[v][cal].astype(float)
        yv = y[cal]
        if v in (0, 1) or np.var(g) == 0 or yv.sum() in (0, cal.sum()):
            assert np.isnan(res.beta[v]), v
            continue
        b, se = _logit_oracle(g, yv, covars[cal])
        np.testing.assert_allclose(res.beta[v], b, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(res.se[v], se, rtol=1e-4)
        # independent stdlib tail — NOT the production normal_sf2
        np.testing.assert_allclose(
            res.p[v], math.erfc(abs(b / se) / math.sqrt(2)), rtol=1e-3
        )
    assert res.p[5] < 0.01  # planted effect found
    # single-class outcome gate
    res1 = glm_logistic(packed, ns, np.ones(ns), covars, block_variants=8)
    assert np.isnan(res1.beta).all()


def test_normal_sf2_known_values():
    from pgen_tpu.ops.logistic import normal_sf2

    np.testing.assert_allclose(normal_sf2(0.0), 1.0, rtol=1e-14)
    np.testing.assert_allclose(normal_sf2(1.959964), 0.05, rtol=1e-5)
    np.testing.assert_allclose(normal_sf2(-2.575829), 0.01, rtol=1e-5)
    assert np.isnan(normal_sf2(np.nan))


def test_cli_glm_logistic_autodetect(tmp_path):
    rng = np.random.default_rng(31)
    nv, ns = 15, 120
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    logit = -0.1 + 0.8 * codes[4]
    case = rng.random(ns) < 1.0 / (1.0 + np.exp(-logit))
    pheno = ["2" if c else "1" for c in case]  # plink 1/2 coding
    prefix = _glm_fileset(tmp_path, codes, pheno)
    out = str(tmp_path / "out.logi")
    assert run_cli(["glm", prefix, "-o", out]) == 0
    lines = (tmp_path / "out.logi").read_text().splitlines()
    assert lines[0].endswith("OBS_CT\tOR\tLOG(OR)_SE\tZ_STAT\tP")
    row4 = lines[5].split("\t")
    b, se = _logit_oracle(
        codes[4].astype(float), case.astype(float), np.zeros((ns, 0))
    )
    np.testing.assert_allclose(float(row4[8]), np.exp(b), rtol=1e-4)
    np.testing.assert_allclose(float(row4[9]), se, rtol=1e-4)
    # --linear forces OLS on the same phenotype
    out2 = str(tmp_path / "out.lin")
    assert run_cli(["glm", prefix, "-o", out2, "--linear"]) == 0
    assert "BETA\tSE\tT_STAT" in (tmp_path / "out.lin").read_text(
    ).splitlines()[0]
    # --logistic on a non-binary phenotype errors
    prefix2 = _glm_fileset(
        tmp_path, codes, [f"{v:.4g}" for v in rng.normal(size=ns)]
    )
    assert run_cli(["glm", prefix2, "--logistic"]) == 1


def test_cli_glm_012_pheno_zero_is_missing(tmp_path):
    # plink2 case/control coding: {0,1,2}-valued phenotype means
    # 0 = missing, 1 = control, 2 = case -> logistic over the non-zeros
    rng = np.random.default_rng(44)
    nv, ns = 10, 150
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    logit = -0.1 + 0.9 * codes[4]
    case = rng.random(ns) < 1.0 / (1.0 + np.exp(-logit))
    pheno = ["2" if c else "1" for c in case]
    miss = [3, 17, 40, 99]
    for i in miss:
        pheno[i] = "0"
    prefix = _glm_fileset(tmp_path, codes, pheno)
    out = str(tmp_path / "out.logi")
    assert run_cli(["glm", prefix, "-o", out]) == 0
    lines = (tmp_path / "out.logi").read_text().splitlines()
    assert lines[0].endswith("OBS_CT\tOR\tLOG(OR)_SE\tZ_STAT\tP")  # logistic
    keep = np.ones(ns, bool)
    keep[miss] = False
    row4 = lines[5].split("\t")
    assert int(row4[7]) == ns - len(miss)
    b, se = _logit_oracle(
        codes[4, keep].astype(float), case[keep].astype(float),
        np.zeros((keep.sum(), 0)),
    )
    np.testing.assert_allclose(float(row4[8]), np.exp(b), rtol=1e-4)
    np.testing.assert_allclose(float(row4[9]), se, rtol=1e-4)


def test_glm_device_centering_large_covars(tmp_path):
    # uncentered f32 moments with birth-year-scale covariates would lose
    # ~7 digits to cancellation; centering keeps the device path usable
    rng = np.random.default_rng(45)
    nv, ns = 30, 200
    codes = rng.binomial(2, 0.3, size=(nv, ns)).astype(np.uint8)
    y = 170.0 + rng.normal(size=ns) * 10.0
    covars = np.column_stack([
        2000.0 + rng.integers(-30, 30, size=ns).astype(float),
        50.0 + rng.normal(size=ns),
    ])
    packed = _pack(codes, tmp_path)
    ref = glm_solve(glm_moments_numpy(packed, ns, y, covars), 2)
    got = glm_solve(
        glm_moments_device(packed, ns, y, covars), 2
    )
    np.testing.assert_allclose(got.beta, ref.beta, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.se, ref.se, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.t_stat, ref.t_stat, rtol=5e-3, atol=1e-3)


def test_glm_logistic_device_matches_numpy(tmp_path):
    from pgen_tpu.ops.logistic import glm_logistic

    rng = np.random.default_rng(46)
    nv, ns = 20, 180
    codes = rng.binomial(2, 0.35, size=(nv, ns)).astype(np.uint8)
    codes[rng.random((nv, ns)) < 0.03] = 3
    covars = rng.normal(size=(ns, 2))
    logit = -0.2 + 0.6 * np.where(codes[3] == 3, 0, codes[3])
    y = (rng.random(ns) < 1.0 / (1.0 + np.exp(-logit))).astype(float)
    packed = _pack(codes, tmp_path)
    ref = glm_logistic(packed, ns, y, covars, provider="numpy")
    got = glm_logistic(packed, ns, y, covars, provider="device")
    nan_ref = np.isnan(ref.beta)
    np.testing.assert_array_equal(np.isnan(got.beta), nan_ref)
    ok = ~nan_ref
    np.testing.assert_allclose(got.beta[ok], ref.beta[ok], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(got.se[ok], ref.se[ok], rtol=1e-3, atol=1e-5)


def test_glm_solve_perfect_fit_is_na():
    # y exactly collinear with [1, g]: rss == 0 -> SE 0 -> NA (not inf),
    # matching plink2's NA for degenerate tests. Exact-arithmetic moments
    # (powers of two) make the zero residual deterministic.
    from pgen_tpu.ops.glm import GlmMoments

    m = GlmMoments(
        n=np.array([4.0]),
        mp=np.array([[4.0, 4.0, 8.0]]),  # [n, sum y, sum y^2], y = g
        gq=np.array([[8.0]]),  # sum g*y
        sg=np.array([4.0]),
        sg2=np.array([8.0]),
    )
    res = glm_solve(m, 0)
    assert np.isnan(res.beta[0])
    assert np.isnan(res.se[0])
    assert np.isnan(res.t_stat[0])
    assert np.isnan(res.p[0])


def test_cli_glm_errors(tmp_path):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 3, size=(5, 6), dtype=np.uint8)
    prefix = _glm_fileset(tmp_path, codes, ["1.0"] * 6)
    # constant phenotype
    assert run_cli(["glm", prefix]) == 1
    # unknown phenotype column
    assert run_cli(["glm", prefix, "--pheno-name", "NOPE"]) == 1
    # too few samples after drops
    prefix2 = _glm_fileset(tmp_path, codes[:, :3],
                           ["1", "2", "NA"])
    assert run_cli(["glm", prefix2]) == 1


# -- Firth fallback (plink2 --glm firth-fallback semantics) ------------------


def _firth_oracle(g, yv, cv, tol=1e-12):
    """Independent penalized-likelihood oracle: explicit design-matrix
    Firth IRLS (Firth 1993; logistf's algorithm) with the hat diagonal
    computed from the full X and W matrices — no shared code with the
    blocked masked-moment implementation under test."""
    n = len(yv)
    x = np.column_stack([np.ones(n), cv, g])
    b = np.zeros(x.shape[1])
    xtwx = None
    for _ in range(500):
        eta = np.clip(x @ b, -30, 30)
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = mu * (1.0 - mu)
        xtwx = x.T @ (w[:, None] * x)
        a = np.linalg.inv(xtwx)
        h = np.einsum("si,ij,sj->s", x, a, x) * w
        step = a @ (x.T @ (yv - mu + h * (0.5 - mu)))
        sc = np.abs(step).max()
        if sc > 5:
            step *= 5.0 / sc
        b += step
        if sc < tol:
            break
    se = np.sqrt(np.linalg.inv(xtwx)[-1, -1])
    return b[-1], se


@pytest.mark.parametrize("k", [0, 2])
def test_firth_fallback_rescues_separation(k, tmp_path):
    """A dosage that perfectly separates case status makes vanilla IRLS
    diverge (plink2 NA's it under no-firth); firth-fallback must fit it
    and match the independent penalized-likelihood oracle."""
    from pgen_tpu.ops.logistic import glm_logistic

    rng = np.random.default_rng(7)
    nv, ns = 6, 120
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    y = (codes[2] >= 1).astype(float)  # variant 2: complete separation
    covars = rng.normal(size=(ns, k))
    packed = _pack(codes, tmp_path)

    off = glm_logistic(packed, ns, y, covars, firth="none")
    assert np.isnan(off.beta[2]), "vanilla IRLS should fail the separated site"
    assert not off.firth.any()

    res = glm_logistic(packed, ns, y, covars)  # default firth-fallback
    b, se = _firth_oracle(codes[2].astype(float), y, covars)
    np.testing.assert_allclose(res.beta[2], b, rtol=1e-6)
    np.testing.assert_allclose(res.se[2], se, rtol=1e-4)
    assert res.firth[2] and np.isfinite(res.p[2])
    # non-separated sites keep their vanilla ML fits (no silent refit)
    for v in (0, 1, 3):
        if np.isfinite(off.beta[v]):
            np.testing.assert_allclose(res.beta[v], off.beta[v], rtol=1e-12)
            assert not res.firth[v]


def test_firth_always_matches_oracle(tmp_path):
    """firth='always' (plink2 --glm firth) must fit EVERY estimable site
    with the penalized likelihood, including well-behaved ones."""
    from pgen_tpu.ops.logistic import glm_logistic

    rng = np.random.default_rng(11)
    nv, ns = 8, 150
    codes = rng.binomial(2, 0.35, size=(nv, ns)).astype(np.uint8)
    codes[rng.random((nv, ns)) < 0.05] = 3
    logit = -0.3 + 0.6 * np.where(codes[4] == 3, 0, codes[4])
    y = (rng.random(ns) < 1.0 / (1.0 + np.exp(-logit))).astype(float)
    covars = rng.normal(size=(ns, 1))
    packed = _pack(codes, tmp_path)
    res = glm_logistic(packed, ns, y, covars, firth="always")
    for v in range(nv):
        cal = codes[v] != 3
        g = codes[v][cal].astype(float)
        yv = y[cal]
        if np.var(g) == 0 or yv.sum() in (0, cal.sum()):
            assert np.isnan(res.beta[v])
            continue
        b, se = _firth_oracle(g, yv, covars[cal])
        np.testing.assert_allclose(res.beta[v], b, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(res.se[v], se, rtol=1e-4)
        assert res.firth[v]


def test_cli_glm_firth_flags(tmp_path):
    """--no-firth NA's the separated site; the default rescues it."""
    rng = np.random.default_rng(23)
    nv, ns = 6, 100
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    case = codes[2] >= 1  # complete separation at variant 2
    pheno = ["2" if c else "1" for c in case]
    prefix = _glm_fileset(tmp_path, codes, pheno)
    out1 = tmp_path / "nofirth.glm"
    assert run_cli(["glm", prefix, "-o", str(out1), "--no-firth"]) == 0
    row = out1.read_text().splitlines()[3].split("\t")
    assert row[8] == "NA" and row[11] == "NA"
    out2 = tmp_path / "firth.glm"
    assert run_cli(["glm", prefix, "-o", str(out2)]) == 0
    row = out2.read_text().splitlines()[3].split("\t")
    b, se = _firth_oracle(
        codes[2].astype(float), case.astype(float), np.zeros((ns, 0))
    )
    np.testing.assert_allclose(float(row[8]), np.exp(b), rtol=1e-4)
    np.testing.assert_allclose(float(row[9]), se, rtol=1e-4)


# -- external --pheno/--covar files and --condition (plink2 surfaces) --------


def test_glm_external_pheno_file(tmp_path):
    """--pheno FILE joined on IID must equal the same values in the psam;
    unlisted samples become missing (dropped)."""
    from pgen_tpu.pipeline.glm import glm_pfile

    rng = np.random.default_rng(51)
    nv, ns = 12, 50
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    y = rng.normal(size=ns)
    pheno = [f"{v:.8g}" for v in y]
    prefix = _glm_fileset(tmp_path, codes, pheno)
    # external file: same values under a new name, SHUFFLED row order
    order = rng.permutation(ns)
    ext = tmp_path / "pheno.tsv"
    ext.write_text(
        "#IID\tBMI\n" + "".join(f"s{i}\t{pheno[i]}\n" for i in order)
    )
    a = glm_pfile(prefix, out_file=str(tmp_path / "a"), write=False)
    b = glm_pfile(
        prefix, pheno_name="BMI", pheno_file=str(ext),
        out_file=str(tmp_path / "b"), write=False,
    )
    np.testing.assert_allclose(b.beta, a.beta, rtol=1e-12, equal_nan=True)
    # a file listing only half the cohort drops the rest
    half = tmp_path / "half.tsv"
    half.write_text(
        "#IID\tBMI\n" + "".join(f"s{i}\t{pheno[i]}\n" for i in range(25))
    )
    c = glm_pfile(
        prefix, pheno_name="BMI", pheno_file=str(half),
        out_file=str(tmp_path / "c"), write=False,
    )
    assert c.num_samples == 25 and c.num_dropped == 25
    # duplicate IID errors
    dup = tmp_path / "dup.tsv"
    dup.write_text("#IID\tBMI\ns0\t1\ns0\t2\n")
    with pytest.raises(ValueError, match="twice"):
        glm_pfile(prefix, pheno_name="BMI", pheno_file=str(dup), write=False)


def test_glm_external_covar_file_and_condition(tmp_path):
    """--covar FILE + --condition: conditioning on a variant's own dosage
    must NA that variant (self-collinearity) and change others' betas
    exactly as appending the dosage column by hand."""
    from pgen_tpu.pipeline.glm import glm_pfile

    rng = np.random.default_rng(52)
    nv, ns = 10, 60
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    codes[2, :5] = 3  # some missing calls in the conditioned variant
    y = 0.5 * codes[2].clip(0, 2) + rng.normal(size=ns)
    prefix = _glm_fileset(tmp_path, codes, [f"{v:.8g}" for v in y])
    cov = rng.normal(size=ns)
    ext = tmp_path / "covar.tsv"
    ext.write_text(
        "#IID\tPC1\n" + "".join(f"s{i}\t{cov[i]:.8g}\n" for i in range(ns))
    )
    res = glm_pfile(
        prefix, covar_names=["PC1"], covar_file=str(ext),
        condition=["rs2"], write=False,
    )
    assert np.isnan(res.beta[2])  # conditioned on itself -> collinear -> NA
    # oracle: hand-append the mean-imputed rs2 dosage as a covariate
    # (per-variant call: running it ON rs2 itself is singular by design)
    cal = codes[2] != 3
    g = codes[2].astype(float)
    g[~cal] = g[cal].mean()
    xcov = np.column_stack([cov, g])
    for v in range(nv):
        if v == 2:
            continue
        n, b, se, t, p = _glm_oracle(codes[v : v + 1], y, xcov)[0]
        if np.isnan(b):
            assert np.isnan(res.beta[v])
        else:
            np.testing.assert_allclose(res.beta[v], b, rtol=1e-6)


def test_cli_glm_condition_list(tmp_path):
    rng = np.random.default_rng(53)
    nv, ns = 8, 40
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    y = rng.normal(size=ns)
    prefix = _glm_fileset(tmp_path, codes, [f"{v:.8g}" for v in y])
    clist = tmp_path / "cond.txt"
    clist.write_text("rs1\nrs4\n")
    out = tmp_path / "o.glm"
    assert run_cli([
        "glm", prefix, "--condition-list", str(clist), "-o", str(out),
    ]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == nv + 1
    # conditioned variants NA'd by self-collinearity
    assert lines[2].split("\t")[8] == "NA"  # rs1
    assert lines[5].split("\t")[8] == "NA"  # rs4
    # unknown condition ID errors
    assert run_cli([
        "glm", prefix, "--condition", "nosuch", "-o", str(out),
    ]) == 1


def test_cli_glm_multi_pheno(tmp_path):
    """Comma-listed --pheno-name runs one GWAS per phenotype and writes
    one output file each (plink2 multi-phenotype behavior)."""
    rng = np.random.default_rng(61)
    nv, ns = 8, 50
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    q1 = 1.2 * codes[2].astype(float) + rng.normal(size=ns)
    q2 = rng.normal(size=ns)
    pvar_rows = [f"1\t{100+i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nv)]
    psam_rows = [
        f"s{i}\tM\t{q1[i]:.6g}\t{q2[i]:.6g}" for i in range(ns)
    ]
    prefix = build_fileset(
        tmp_path, "mp", codes, pvar_rows, psam_rows,
        psam_columns="#IID\tSEX\tQ1\tQ2",
    )
    base = tmp_path / "gw"
    assert run_cli(["glm", prefix, "--pheno-name", "Q1,Q2",
                    "-o", str(base)]) == 0
    # documented layout: {base}.{pheno}.glm.{model} (r4 advisor finding —
    # the model suffix keeps linear/logistic runs from colliding)
    out1 = tmp_path / "gw.Q1.glm.linear"
    out2 = tmp_path / "gw.Q2.glm.linear"
    assert out1.exists() and out2.exists()
    r1 = [ln.split("\t") for ln in out1.read_text().splitlines()[1:]]
    r2 = [ln.split("\t") for ln in out2.read_text().splitlines()[1:]]
    assert len(r1) == nv and len(r2) == nv
    # the planted Q1 effect at rs2 is significant there, not in Q2
    p1 = float(r1[2][-1])
    p2 = float(r2[2][-1])
    assert p1 < 1e-6 and p2 > 1e-6
    # per-pheno results equal the single-pheno runs
    assert run_cli(["glm", prefix, "--pheno-name", "Q1",
                    "-o", str(tmp_path / "solo")]) == 0
    assert (tmp_path / "solo").read_text() == out1.read_text()
    # stdout + multiple phenotypes is rejected
    assert run_cli(["glm", prefix, "--pheno-name", "Q1,Q2",
                    "-o", "-"]) == 2


def test_cli_glm_covar_variance_standardize_add_invariant(tmp_path):
    """--covar-variance-standardize leaves the ADD test unchanged (an
    affine covariate transform) while stabilizing wild scales."""
    rng = np.random.default_rng(71)
    nv, ns = 6, 60
    codes = rng.binomial(2, 0.4, size=(nv, ns)).astype(np.uint8)
    big = rng.normal(5e6, 1e6, size=ns)  # wild-scale covariate
    y = 0.8 * codes[1].astype(float) + 1e-7 * big + rng.normal(size=ns)
    pvar_rows = [f"1\t{100+i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nv)]
    psam_rows = [f"s{i}\t{y[i]:.8g}\t{big[i]:.8g}" for i in range(ns)]
    prefix = build_fileset(
        tmp_path, "cvs", codes, pvar_rows, psam_rows,
        psam_columns="#IID\tPHENO1\tBIGC",
    )
    o1 = tmp_path / "a.glm"
    o2 = tmp_path / "b.glm"
    assert run_cli(["glm", prefix, "--covar-name", "BIGC",
                    "-o", str(o1)]) == 0
    assert run_cli(["glm", prefix, "--covar-name", "BIGC",
                    "--covar-variance-standardize", "-o", str(o2)]) == 0
    r1 = [ln.split("\t") for ln in o1.read_text().splitlines()[1:]]
    r2 = [ln.split("\t") for ln in o2.read_text().splitlines()[1:]]
    for a, b in zip(r1, r2):
        # BETA/SE/T/P of the ADD test agree to solver precision
        for c in range(8, 12):
            np.testing.assert_allclose(float(a[c]), float(b[c]), rtol=1e-6)
    # constant covariate errors clearly
    psam_rows_c = [f"s{i}\t{y[i]:.8g}\t7" for i in range(ns)]
    prefix_c = build_fileset(
        tmp_path, "cvc", codes, pvar_rows, psam_rows_c,
        psam_columns="#IID\tPHENO1\tBIGC",
    )
    assert run_cli(["glm", prefix_c, "--covar-name", "BIGC",
                    "--covar-variance-standardize",
                    "-o", str(o1)]) != 0


def test_native_sparse_moments_match_numpy(tmp_path):
    """The C++ sparse-complement moments provider (pgen_glm_moments) is
    bit-equivalent to the blocked-dgemm numpy path on full and subset
    cohorts, including missing-heavy and monomorphic variants."""
    from pgen_tpu.ops.glm import glm_moments_native

    rng = np.random.default_rng(44)
    nv, ns, k = 40, 37, 2
    codes = rng.integers(0, 4, size=(nv, ns)).astype(np.uint8)
    codes[3] = 0          # all hom-ref (every byte skipped)
    codes[5] = 3          # all missing
    packed = _pack(codes, tmp_path)
    y = rng.normal(size=ns)
    cov = rng.normal(size=(ns, k))
    b = glm_moments_native(packed, ns, y, cov)
    if b is None:
        pytest.skip("native runtime unavailable")
    a = glm_moments_numpy(packed, ns, y, cov)
    for x, z, name in zip(a, b, a._fields):
        np.testing.assert_allclose(x, z, rtol=1e-12, atol=1e-9,
                                   err_msg=name)
    idx = np.sort(rng.choice(ns, size=21, replace=False)).astype(np.int32)
    a2 = glm_moments_numpy(packed, ns, y[idx], cov[idx], sample_idx=idx)
    b2 = glm_moments_native(packed, ns, y[idx], cov[idx], sample_idx=idx)
    for x, z, name in zip(a2, b2, a2._fields):
        np.testing.assert_allclose(x, z, rtol=1e-12, atol=1e-9,
                                   err_msg=f"subset {name}")
    # provider switch end-to-end
    ra = glm_linear(packed, ns, y, cov, provider="numpy")
    rb = glm_linear(packed, ns, y, cov, provider="native")
    both = np.isfinite(ra.beta) & np.isfinite(rb.beta)
    np.testing.assert_allclose(ra.beta[both], rb.beta[both], rtol=1e-10)


def test_native_moments_threaded_split_parity():
    """A >=16 MiB input exercises pgen_glm_moments_par's two-thread
    split (mid-offset pointer arithmetic over five output arrays) —
    small parity tests never reach it (r5 review finding)."""
    from pgen_tpu.ops.glm import glm_moments_native

    ns = 2504
    rec = (2 * ns + 7) // 8  # 626: no pad bits (2504 = 4*626)
    nv = (16 << 20) // rec + 512  # just past the threaded threshold
    rng = np.random.default_rng(60)
    packed = rng.integers(0, 256, size=(nv, rec), dtype=np.uint8)
    y = rng.normal(size=ns)
    cov = rng.normal(size=(ns, 1))
    b = glm_moments_native(packed, ns, y, cov)
    if b is None:
        pytest.skip("native runtime unavailable")
    a = glm_moments_numpy(packed, ns, y, cov)
    for x, z, name in zip(a, b, a._fields):
        np.testing.assert_allclose(x, z, rtol=1e-12, atol=1e-8,
                                   err_msg=name)
    # the halves boundary specifically
    mid = nv // 2
    for v in (mid - 1, mid, mid + 1):
        np.testing.assert_allclose(a.mp[v], b.mp[v], rtol=1e-12)


def test_native_moments_rejects_bad_shapes_and_dup_idx(tmp_path):
    from pgen_tpu.ops.glm import glm_moments_native

    rng = np.random.default_rng(61)
    codes = rng.integers(0, 4, size=(4, 8)).astype(np.uint8)
    packed = _pack(codes, tmp_path)
    if glm_moments_native(packed, 8, np.zeros(8), np.zeros((8, 0))) is None:
        pytest.skip("native runtime unavailable")
    with pytest.raises(ValueError, match="do not match|holds"):
        glm_moments_native(packed, 8, np.zeros(5), np.zeros((5, 0)))
    # duplicated sample indices: numpy semantics required -> fallback None
    dup = np.array([0, 0, 1], dtype=np.int32)
    assert glm_moments_native(
        packed, 8, np.zeros(3), np.zeros((3, 0)), sample_idx=dup
    ) is None


def test_logistic_counts_fast_path_matches_per_sample(tmp_path):
    """k = 0 logistic collapses to 2x3-table sufficient statistics
    (_logistic_fit_counts): same Newton/Firth iteration on class sums,
    ~100x faster — must agree with the per-sample block path in every
    firth mode, on subsets, and for the 2-column hethom design."""
    from pgen_tpu.ops.glm import MODIFIER_COLS
    from pgen_tpu.ops.logistic import _ADD_GLUT, _logistic_fit_multi

    rng = np.random.default_rng(91)
    nv, ns = 30, 120
    codes = rng.integers(0, 4, size=(nv, ns)).astype(np.uint8)
    codes[2] = 0  # monomorphic -> NA both paths
    y = (rng.random(ns) < 1.0 / (
        1.0 + np.exp(-0.7 * (codes[5] == 2)))).astype(float)
    packed = _pack(codes, tmp_path)
    cov0 = np.zeros((ns, 0))
    passthrough = lambda a, b: a @ b  # noqa: E731 - forces per-sample path

    def _cmp(fast, slow, rtol=2e-6):
        for i in (0, 1, 2, 3, 4):
            a = np.asarray(fast[i], float)
            b = np.asarray(slow[i], float)
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(a[fin], b[fin], rtol=rtol,
                                       atol=1e-9)
        np.testing.assert_array_equal(fast[8], slow[8])  # firth flags

    for firth in ("none", "fallback", "always"):
        fast = _logistic_fit_multi(packed, ns, y, cov0, 4096, None, 24,
                                   1e-7, None, firth, _ADD_GLUT)
        slow = _logistic_fit_multi(packed, ns, y, cov0, 4096, None, 24,
                                   1e-7, passthrough, firth, _ADD_GLUT)
        _cmp(fast, slow)
    idx = np.sort(rng.permutation(ns)[:80]).astype(np.int32)
    fast = _logistic_fit_multi(packed, ns, y[idx], cov0[:80], 4096, idx,
                               24, 1e-7, None, "fallback", _ADD_GLUT)
    slow = _logistic_fit_multi(packed, ns, y[idx], cov0[:80], 4096, idx,
                               24, 1e-7, passthrough, "fallback", _ADD_GLUT)
    _cmp(fast, slow)
    hh = MODIFIER_COLS["hethom"]
    fast = _logistic_fit_multi(packed, ns, y, cov0, 4096, None, 24, 1e-7,
                               None, "none", hh)
    slow = _logistic_fit_multi(packed, ns, y, cov0, 4096, None, 24, 1e-7,
                               passthrough, "none", hh)
    _cmp(fast, slow)
    jf = np.isfinite(fast[5]) & np.isfinite(slow[5])
    np.testing.assert_allclose(fast[5][jf], slow[5][jf], rtol=2e-5)


def test_logistic_grouped_covariate_fast_path(tmp_path):
    """Few-unique-covariate-row designs (SEX, batch) also collapse to
    cell sufficient statistics (3G cells): the grouped fast path must
    agree with the per-sample IRLS in every firth mode; continuous
    covariates (G > 16) must keep the per-sample path."""
    from pgen_tpu.ops.logistic import _ADD_GLUT, _logistic_fit_multi

    rng = np.random.default_rng(92)
    nv, ns = 25, 160
    codes = rng.integers(0, 4, size=(nv, ns)).astype(np.uint8)
    sex = (rng.random(ns) < 0.5).astype(float)
    batch = rng.integers(0, 3, ns).astype(float)
    cov = np.column_stack([sex, batch])  # 6 unique rows
    y = (rng.random(ns) < 1.0 / (1.0 + np.exp(
        -(0.4 * sex + 0.6 * (codes[4] == 2))))).astype(float)
    packed = _pack(codes, tmp_path)
    passthrough = lambda a, b: a @ b  # noqa: E731
    for firth in ("none", "fallback", "always"):
        fast = _logistic_fit_multi(packed, ns, y, cov, 4096, None, 24,
                                   1e-7, None, firth, _ADD_GLUT)
        slow = _logistic_fit_multi(packed, ns, y, cov, 4096, None, 24,
                                   1e-7, passthrough, firth, _ADD_GLUT)
        for i in (0, 1, 2, 3, 4):
            a = np.asarray(fast[i], float)
            b = np.asarray(slow[i], float)
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(a[fin], b[fin], rtol=5e-6,
                                       atol=1e-9)
        np.testing.assert_array_equal(fast[8], slow[8])
    # grouped + sample_idx subset together: cohort/group_inv positional
    # alignment is the one spot the two single-feature tests miss
    idx = np.sort(rng.permutation(ns)[:120]).astype(np.int32)
    fast = _logistic_fit_multi(packed, ns, y[idx], cov[idx], 4096, idx,
                               24, 1e-7, None, "fallback", _ADD_GLUT)
    slow = _logistic_fit_multi(packed, ns, y[idx], cov[idx], 4096, idx,
                               24, 1e-7, passthrough, "fallback",
                               _ADD_GLUT)
    fin = np.isfinite(fast[1]) & np.isfinite(slow[1])
    np.testing.assert_allclose(fast[1][fin], slow[1][fin], rtol=5e-6,
                               atol=1e-9)
    # continuous covariate: many unique rows, same answer either way
    # (routed through the per-sample path — just confirm it still runs)
    contc = rng.normal(size=(ns, 1))
    r = _logistic_fit_multi(packed, ns, y, contc, 4096, None, 24, 1e-7,
                            None, "none", _ADD_GLUT)
    assert np.isfinite(r[1]).any()


@pytest.mark.parametrize("ns", [8, 9, 10, 11])  # every pad residue
def test_native_moments_shape_fuzz(ns, tmp_path):
    """Native sparse kernels vs numpy across pad-bit residues
    (n_samples % 4 in {0,1,2,3}) and random shapes — the `lim` bound in
    the C++ byte loop is the only thing between a pad bit and a wrong
    moment."""
    from pgen_tpu.ops.glm import (
        glm_geno_moments_native,
        glm_geno_moments_numpy,
        glm_moments_native,
    )
    from pgen_tpu.ops.score import score_native, score_numpy

    rng = np.random.default_rng(100 + ns)
    for trial in range(3):
        nv = int(rng.integers(1, 25))
        k = int(rng.integers(0, 3))
        codes = rng.integers(0, 4, size=(nv, ns)).astype(np.uint8)
        y = rng.normal(size=ns)
        cov = rng.normal(size=(ns, k))
        packed = _pack(codes, tmp_path, name=f"f{ns}_{trial}").copy()
        if ns % 4:
            # force NONZERO pad bits: the writer zeroes them, but the
            # format does not guarantee it — only the kernels' sample
            # bound keeps them out of the moments
            packed[:, -1] |= np.uint8((0xFF << (2 * (ns % 4))) & 0xFF)
        b = glm_moments_native(packed, ns, y, cov)
        if b is None:
            pytest.skip("native runtime unavailable")
        a = glm_moments_numpy(packed, ns, y, cov)
        for x, z in zip(a, b):
            np.testing.assert_allclose(x, z, rtol=1e-12, atol=1e-9)
        g = glm_geno_moments_native(packed, ns, y, cov)
        gn = glm_geno_moments_numpy(packed, ns, y, cov)
        for x, z in zip(gn, g):
            np.testing.assert_allclose(x, z, rtol=1e-12, atol=1e-9)
        w = rng.normal(size=(nv, 2))
        flip = rng.random(nv) < 0.5
        s_nat = score_native(packed, ns, w, flip)
        s_np = score_numpy(packed, ns, w, flip)
        np.testing.assert_allclose(s_nat.sums, s_np.sums, rtol=1e-12,
                                   atol=1e-10)
        np.testing.assert_array_equal(s_nat.allele_ct, s_np.allele_ct)
