"""Polygenic scoring: providers vs an explicit per-variant oracle, allele
orientation, imputation modes, mesh psum, and the CLI .sscore surface."""

import numpy as np
import pytest

from tests.cli_helpers import run_cli
from tests.conftest import build_fileset

from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops.score import score_device, score_numpy
from pgen_tpu.pipeline.score import parse_col_nums, read_score_file


def _pack(codes: np.ndarray, tmp_path, name="p") -> np.ndarray:
    path = str(tmp_path / f"{name}.pgen")
    write_pgen(path, codes)
    rec = (2 * codes.shape[1] + 7) // 8
    return np.fromfile(path, dtype=np.uint8)[12:].reshape(codes.shape[0], rec)


def _score_oracle(codes, weights, flip, mean_impute=True):
    """Explicit f64 reference: per-variant dosage, impute, outer-product."""
    nv, ns = codes.shape
    sums = np.zeros((ns, weights.shape[1]))
    dos = np.zeros(ns)
    ct = np.zeros(ns, dtype=np.int64)
    m = 0
    for v in range(nv):
        called = codes[v] != 3
        n = called.sum()
        if n == 0:
            continue
        m += 1
        g = codes[v].astype(np.float64) * called
        d = 2.0 * called - g if flip[v] else g
        if mean_impute:
            d = np.where(called, d, d.sum() / n)
            ct += 2
        else:
            ct += 2 * called
        sums += np.outer(d, weights[v])
        dos += d
    return sums, dos, ct, m


@pytest.mark.parametrize("mean_impute", [True, False])
@pytest.mark.parametrize("shape", [(9, 4), (60, 7), (33, 13)])
def test_score_numpy_matches_oracle(shape, mean_impute, tmp_path):
    rng = np.random.default_rng(shape[0] + mean_impute)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    codes[0] = 3  # all-missing row: contributes nothing, never counted
    w = rng.normal(size=(shape[0], 2))
    flip = rng.random(shape[0]) < 0.5
    packed = _pack(codes, tmp_path)
    ref = _score_oracle(codes, w, flip, mean_impute)
    got = score_numpy(packed, shape[1], w, flip, mean_impute=mean_impute,
                      block_variants=8)
    np.testing.assert_allclose(got.sums, ref[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.dosage_sum, ref[1], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.allele_ct, ref[2])
    assert got.m_used == ref[3]


@pytest.mark.parametrize("mean_impute", [True, False])
def test_score_device_matches_numpy(mean_impute, tmp_path):
    rng = np.random.default_rng(2 + mean_impute)
    codes = rng.integers(0, 4, size=(50, 9), dtype=np.uint8)
    w = rng.normal(size=(50, 3))
    flip = rng.random(50) < 0.5
    packed = _pack(codes, tmp_path)
    ref = score_numpy(packed, 9, w, flip, mean_impute=mean_impute)
    got = score_device(packed, 9, w, flip, mean_impute=mean_impute,
                       block_variants=16)
    np.testing.assert_allclose(got.sums, ref.sums, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.dosage_sum, ref.dosage_sum,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.allele_ct, ref.allele_ct)
    assert got.m_used == ref.m_used


def test_score_sample_subset(tmp_path):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, size=(40, 10), dtype=np.uint8)
    w = rng.normal(size=(40, 1))
    flip = rng.random(40) < 0.5
    packed = _pack(codes, tmp_path)
    sel = np.array([1, 2, 6, 9], dtype=np.int32)
    ref = _score_oracle(codes[:, sel], w, flip)
    got = score_numpy(packed, 10, w, flip, sample_idx=sel)
    np.testing.assert_allclose(got.sums, ref[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.allele_ct, ref[2])
    dev = score_device(packed, 10, w, flip, sample_idx=sel,
                       block_variants=16)
    np.testing.assert_allclose(dev.sums, ref[0], rtol=2e-5, atol=2e-5)


def test_score_mesh_psum_matches_numpy(tmp_path):
    import jax

    from pgen_tpu.ops.score import score_mesh

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(41, 5), dtype=np.uint8)
    w = rng.normal(size=(41, 2))
    flip = rng.random(41) < 0.5
    packed = _pack(codes, tmp_path)
    ref = score_numpy(packed, 5, w, flip)
    got = score_mesh(packed, 5, w, flip, block_variants=4)
    assert len(jax.devices()) > 1  # conftest forces the 8-device CPU mesh
    np.testing.assert_allclose(got.sums, ref.sums, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.allele_ct, ref.allele_ct)
    assert got.m_used == ref.m_used


def test_parse_col_nums():
    assert parse_col_nums("3") == (3,)
    assert parse_col_nums("3-5,7") == (3, 4, 5, 7)
    with pytest.raises(ValueError):
        parse_col_nums("5-3")
    with pytest.raises(ValueError):
        parse_col_nums("")
    with pytest.raises(ValueError):
        parse_col_nums("a")


def test_read_score_file_header_autodetect(tmp_path):
    p = tmp_path / "w.tsv"
    p.write_text("ID\tA1\tBETA_BMI\tBETA_HT\n"
                 "rs1\tG\t0.5\t-1\n"
                 "rs2\tA\t-0.25\t2\n")
    t = read_score_file(str(p), weight_cols=(3, 4))
    assert t.names == ["BETA_BMI", "BETA_HT"]
    assert t.ids == ["rs1", "rs2"] and t.alleles == ["G", "A"]
    np.testing.assert_allclose(t.weights, [[0.5, -1.0], [-0.25, 2.0]])
    # headerless flavor
    p2 = tmp_path / "w2.tsv"
    p2.write_text("rs1 G 0.5\nrs2 A -0.25\n")
    t2 = read_score_file(str(p2))
    assert t2.names == ["SCORE1"] and t2.ids == ["rs1", "rs2"]


def test_read_score_file_header_heuristic_hardening(tmp_path):
    # headerless file whose first weight cell is a missing token must NOT
    # be silently reclassified as a header (dropping the row) — it is a
    # data row with a bad cell, reported as such
    p = tmp_path / "na.tsv"
    p.write_text("rs1\tG\tNA\nrs2\tA\t0.5\n")
    with pytest.raises(ValueError, match="line 1.*not a number"):
        read_score_file(str(p))
    # numeric ID cell on line 1 -> data, even though the weight cell
    # fails to parse (guards against numeric-named fabrication)
    p2 = tmp_path / "numid.tsv"
    p2.write_text("1234\tG\tNA\nrs2\tA\t0.5\n")
    with pytest.raises(ValueError, match="line 1.*not a number"):
        read_score_file(str(p2))
    # explicit override wins both ways
    p3 = tmp_path / "force.tsv"
    p3.write_text("ID\tA1\t2019\nrs1\tG\t0.5\n")
    t = read_score_file(str(p3), header_row="yes")
    assert t.names == ["2019"] and t.ids == ["rs1"]
    t2 = read_score_file(str(p3), header_row="no")
    assert t2.names == ["SCORE1"] and t2.ids == ["ID", "rs1"]
    with pytest.raises(ValueError, match="header_row"):
        read_score_file(str(p3), header_row="maybe")


def test_read_score_file_errors(tmp_path):
    p = tmp_path / "bad.tsv"
    p.write_text("rs1\tG\t0.5\nrs1\tG\t0.25\n")
    with pytest.raises(ValueError, match="duplicate"):
        read_score_file(str(p))
    p.write_text("rs1\tG\tx\n")  # lone unparseable weight reads as a header
    with pytest.raises(ValueError, match="no data rows"):
        read_score_file(str(p))
    p.write_text("ID\tA1\tW\nrs1\tG\tx\n")
    with pytest.raises(ValueError, match="not a number"):
        read_score_file(str(p))
    p.write_text("rs1\tG\n")
    with pytest.raises(ValueError, match="fields"):
        read_score_file(str(p))


def _score_fileset(tmp_path, codes):
    nvar, ns = codes.shape
    pvar_rows = [f"1\t{100 + i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nvar)]
    psam_rows = [f"s{i}\t{'F' if i % 2 else 'M'}" for i in range(ns)]
    return build_fileset(tmp_path, "score", codes, pvar_rows, psam_rows)


def test_cli_score_end_to_end(tmp_path):
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(30, 6), dtype=np.uint8)
    prefix = _score_fileset(tmp_path, codes)
    # effect allele: ALT (G) for even variants, REF (A) -> flipped for odd
    w = rng.normal(size=(30, 1))
    lines = [
        f"rs{i}\t{'G' if i % 2 == 0 else 'A'}\t{w[i, 0]:.10g}"
        for i in range(30)
    ]
    sf = tmp_path / "weights.tsv"
    sf.write_text("\n".join(lines) + "\n")
    out = str(tmp_path / "out.sscore")
    assert run_cli(["score", prefix, "--score", str(sf), "-o", out,
                    "--score-sums"]) == 0
    got = (tmp_path / "out.sscore").read_text().splitlines()
    assert got[0] == "#IID\tALLELE_CT\tDOSAGE_SUM\tSCORE1_AVG\tSCORE1_SUM"
    assert len(got) == 7
    flip = np.array([i % 2 == 1 for i in range(30)])
    ref_sums, ref_dos, ref_ct, _ = _score_oracle(codes, w, flip)
    for r, line in enumerate(got[1:]):
        cells = line.split("\t")
        assert cells[0] == f"s{r}"
        assert int(cells[1]) == ref_ct[r]
        np.testing.assert_allclose(float(cells[2]), ref_dos[r], atol=1e-5)
        np.testing.assert_allclose(
            float(cells[3]), ref_sums[r, 0] / ref_ct[r], atol=1e-9
        )
        np.testing.assert_allclose(float(cells[4]), ref_sums[r, 0], atol=1e-9)


def test_cli_score_provider_parity_and_filters(tmp_path):
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, size=(40, 7), dtype=np.uint8)
    prefix = _score_fileset(tmp_path, codes)
    lines = ["VARID A1 W"] + [
        f"rs{i} G {rng.normal():.6g}" for i in range(40)
    ]
    sf = tmp_path / "w.tsv"
    sf.write_text("\n".join(lines) + "\n")
    texts = []
    for prov in ("numpy", "device"):
        out = str(tmp_path / f"{prov}.sscore")
        assert run_cli([
            "score", prefix, "--score", str(sf), "-o", out,
            "--provider", prov, "--samples", "s0,s2,s3,s5",
            "--include-var", 'POS != "101"',
        ]) == 0
        lines_out = (tmp_path / f"{prov}.sscore").read_text().splitlines()
        assert lines_out[0].endswith("W_AVG")
        assert [l.split("\t")[0] for l in lines_out[1:]] == [
            "s0", "s2", "s3", "s5"
        ]
        texts.append(
            np.array([[float(x) for x in l.split("\t")[1:]]
                      for l in lines_out[1:]])
        )
    np.testing.assert_allclose(texts[0], texts[1], rtol=2e-5, atol=2e-5)
    # the excluded variant (rs1) reduces the denominator by 2
    assert int(texts[0][0, 0]) == 2 * 39


def test_cli_score_unmatched_and_mismatched(tmp_path, capsys):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 3, size=(10, 4), dtype=np.uint8)
    prefix = _score_fileset(tmp_path, codes)
    sf = tmp_path / "w.tsv"
    sf.write_text("rs0 G 1\nrs1 T 1\nnope G 1\n")  # T matches neither A/G
    assert run_cli(["score", prefix, "--score", str(sf), "-o", "-"]) == 0
    out = capsys.readouterr().out
    rows = out.splitlines()
    assert rows[0].startswith("#IID")
    # only rs0 scored: ALLELE_CT == 2 everywhere
    assert all(r.split("\t")[1] == "2" for r in rows[1:])


def test_cli_score_no_match_errors(tmp_path):
    rng = np.random.default_rng(14)
    codes = rng.integers(0, 3, size=(5, 3), dtype=np.uint8)
    prefix = _score_fileset(tmp_path, codes)
    sf = tmp_path / "w.tsv"
    sf.write_text("zzz G 1\n")
    assert run_cli(["score", prefix, "--score", str(sf)]) == 1


def test_cli_score_no_mean_imputation(tmp_path):
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 4, size=(20, 5), dtype=np.uint8)
    prefix = _score_fileset(tmp_path, codes)
    w = rng.normal(size=(20, 1))
    sf = tmp_path / "w.tsv"
    sf.write_text("".join(f"rs{i} G {w[i, 0]:.10g}\n" for i in range(20)))
    out = str(tmp_path / "ni.sscore")
    assert run_cli(["score", prefix, "--score", str(sf), "-o", out,
                    "--no-mean-imputation"]) == 0
    ref_sums, _, ref_ct, _ = _score_oracle(codes, w,
                                           np.zeros(20, bool), False)
    rows = (tmp_path / "ni.sscore").read_text().splitlines()[1:]
    for r, line in enumerate(rows):
        cells = line.split("\t")
        assert int(cells[1]) == ref_ct[r]
        denom = max(ref_ct[r], 1)
        np.testing.assert_allclose(
            float(cells[3]), ref_sums[r, 0] / denom, atol=1e-9
        )


def _qsr_fileset(tmp_path):
    rng = np.random.default_rng(21)
    nv, ns = 10, 6
    codes = rng.integers(0, 3, size=(nv, ns), dtype=np.uint8)
    pvar_rows = [f"1\t{100+i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nv)]
    psam_rows = [f"s{i}\tM" for i in range(ns)]
    prefix = build_fileset(tmp_path, "qsr", codes, pvar_rows, psam_rows)
    score = tmp_path / "w.tsv"
    score.write_text(
        "ID\tA1\tW\n"
        + "".join(f"rs{i}\tG\t{0.1 * (i + 1):.2f}\n" for i in range(nv))
    )
    return prefix, codes, score


def test_q_score_range_partitions(tmp_path):
    prefix, codes, score = _qsr_fileset(tmp_path)
    # p-values: rs0..rs4 significant (1e-8), rs5..rs9 not (0.5)
    data = tmp_path / "p.tsv"
    data.write_text(
        "SNP\tP\n"
        + "".join(
            f"rs{i}\t{1e-8 if i < 5 else 0.5}\n" for i in range(10)
        )
    )
    ranges = tmp_path / "r.txt"
    ranges.write_text("S1 0 1e-5\nS2 0 1\nEMPTY 2 3\n")
    out = tmp_path / "o"
    assert run_cli([
        "score", prefix, "--score", str(score),
        "--q-score-range", str(ranges), str(data), "-o", str(out),
    ]) == 0
    s1 = (tmp_path / "o.S1.sscore").read_text().splitlines()
    s2 = (tmp_path / "o.S2.sscore").read_text().splitlines()
    assert not (tmp_path / "o.EMPTY.sscore").exists()
    # S2 covers all 10 variants, S1 only the 5 significant ones
    w = np.array([[0.1 * (i + 1)] for i in range(10)])
    flip = np.zeros(10, dtype=bool)
    sums1, _, ct1, _ = _score_oracle(codes[:5], w[:5], flip[:5])
    sums2, _, ct2, _ = _score_oracle(codes, w, flip)
    for lines, sums, ct in ((s1, sums1, ct1), (s2, sums2, ct2)):
        for r, ln in enumerate(lines[1:]):
            cells = ln.split("\t")
            assert int(cells[1]) == ct[r]
            assert float(cells[3]) == pytest.approx(
                sums[r, 0] / max(ct[r], 1), rel=1e-9
            )


def test_q_score_range_errors(tmp_path):
    prefix, _, score = _qsr_fileset(tmp_path)
    bad = tmp_path / "bad.txt"
    bad.write_text("S1 0\n")
    data = tmp_path / "p.tsv"
    data.write_text("rs0\t0.5\n")
    assert run_cli([
        "score", prefix, "--score", str(score),
        "--q-score-range", str(bad), str(data),
    ]) != 0
    # no range matches -> error
    ranges = tmp_path / "r.txt"
    ranges.write_text("S1 0 1e-20\n")
    assert run_cli([
        "score", prefix, "--score", str(score),
        "--q-score-range", str(ranges), str(data),
    ]) != 0


def test_q_score_range_streams_to_stdout(tmp_path, capsys):
    # `-o -`: one combined table with a leading RANGE column on stdout,
    # no per-range files on disk (ADVICE r3: files were silently written)
    prefix, codes, score = _qsr_fileset(tmp_path)
    data = tmp_path / "p.tsv"
    data.write_text(
        "SNP\tP\n"
        + "".join(f"rs{i}\t{1e-8 if i < 5 else 0.5}\n" for i in range(10))
    )
    ranges = tmp_path / "r.txt"
    ranges.write_text("S1 0 1e-5\nS2 0 1\n")
    assert run_cli([
        "score", prefix, "--score", str(score),
        "--q-score-range", str(ranges), str(data), "-o", "-",
    ]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split("\t")[:2] == ["#RANGE", "IID"]
    body = [ln.split("\t") for ln in lines[1:]]
    assert [r[0] for r in body] == ["S1"] * 6 + ["S2"] * 6
    assert not list(tmp_path.glob("*.sscore"))
    # row values match the file-mode S1/S2 tables
    w = np.array([[0.1 * (i + 1)] for i in range(10)])
    flip = np.zeros(10, dtype=bool)
    sums1, _, ct1, _ = _score_oracle(codes[:5], w[:5], flip[:5])
    for r, cells in enumerate(body[:6]):
        assert int(cells[2]) == ct1[r]
        assert float(cells[4]) == pytest.approx(
            sums1[r, 0] / max(ct1[r], 1), rel=1e-9
        )


# ---- center / variance-standardize (plink2 --score modifiers) --------------


def _transformed_oracle(codes, w, flip, mode):
    """Explicit per-cell transform: impute missing to the variant mean,
    then center (and scale by the cohort sd for variance-standardize)."""
    nv, ns = codes.shape
    d = np.where(flip[:, None], 2.0 - codes, codes.astype(float))
    d[codes == 3] = np.nan
    mu = np.nanmean(d, axis=1)
    sd = np.sqrt(np.nanvar(d, axis=1))
    for v in range(nv):
        d[v] = np.where(np.isnan(d[v]), mu[v], d[v]) - mu[v]
        if mode == "vs":
            d[v] /= sd[v]
    return d.T @ w


def test_score_center_matches_explicit_transform(tmp_path):
    rng = np.random.default_rng(33)
    nv, ns = 15, 12
    codes = rng.integers(0, 3, size=(nv, ns), dtype=np.uint8)
    codes[rng.random((nv, ns)) < 0.15] = 3
    pvar_rows = [f"1\t{100+i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nv)]
    psam_rows = [f"s{i}\tM" for i in range(ns)]
    prefix = build_fileset(tmp_path, "ctr", codes, pvar_rows, psam_rows)
    w = rng.normal(size=(nv, 1))
    flip = rng.random(nv) < 0.4
    score_f = tmp_path / "w.tsv"
    score_f.write_text("ID\tA1\tW\n" + "".join(
        f"rs{i}\t{'A' if flip[i] else 'G'}\t{w[i,0]:.8g}\n"
        for i in range(nv)
    ))
    out = tmp_path / "o.sscore"
    assert run_cli(["score", prefix, "--score", str(score_f),
                    "--score-sums", "--center", "-o", str(out)]) == 0
    rows = out.read_text().splitlines()[1:]
    got = np.array([float(r.split("\t")[-1]) for r in rows])
    exp = _transformed_oracle(codes, w, flip, "center")[:, 0]
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-9)
    # centered scores sum to ~0 over the cohort
    assert abs(got.sum()) < 1e-6 * max(1.0, np.abs(got).sum())


def test_score_variance_standardize_matches_explicit_transform(tmp_path):
    rng = np.random.default_rng(35)
    nv, ns = 10, 20
    # guarantee nonzero variance per variant
    while True:
        codes = rng.integers(0, 3, size=(nv, ns), dtype=np.uint8)
        if all(np.var(codes[v]) > 0 for v in range(nv)):
            break
    pvar_rows = [f"1\t{100+i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nv)]
    psam_rows = [f"s{i}\tM" for i in range(ns)]
    prefix = build_fileset(tmp_path, "vs", codes, pvar_rows, psam_rows)
    w = rng.normal(size=(nv, 1))
    score_f = tmp_path / "w.tsv"
    score_f.write_text("ID\tA1\tW\n" + "".join(
        f"rs{i}\tG\t{w[i,0]:.8g}\n" for i in range(nv)
    ))
    out = tmp_path / "o.sscore"
    assert run_cli(["score", prefix, "--score", str(score_f),
                    "--score-sums", "--variance-standardize",
                    "-o", str(out)]) == 0
    rows = out.read_text().splitlines()[1:]
    got = np.array([float(r.split("\t")[-1]) for r in rows])
    exp = _transformed_oracle(
        codes, w, np.zeros(nv, bool), "vs"
    )[:, 0]
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-9)


def test_score_transform_guards(tmp_path):
    codes = np.ones((3, 4), dtype=np.uint8)  # zero variance everywhere
    pvar_rows = [f"1\t{100+i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(3)]
    psam_rows = [f"s{i}\tM" for i in range(4)]
    prefix = build_fileset(tmp_path, "zg", codes, pvar_rows, psam_rows)
    score_f = tmp_path / "w.tsv"
    score_f.write_text("ID\tA1\tW\nrs0\tG\t1\nrs1\tG\t1\n")
    out = tmp_path / "o.sscore"
    assert run_cli(["score", prefix, "--score", str(score_f),
                    "--variance-standardize", "-o", str(out)]) != 0
    assert run_cli(["score", prefix, "--score", str(score_f), "--center",
                    "--no-mean-imputation", "-o", str(out)]) != 0
    # center alone works on the zero-variance fileset (scores become 0)
    assert run_cli(["score", prefix, "--score", str(score_f), "--center",
                    "--score-sums", "-o", str(out)]) == 0
    got = [float(r.split("\t")[-1]) for r in out.read_text().splitlines()[1:]]
    assert all(abs(v) < 1e-12 for v in got)


def test_native_sparse_score_matches_numpy(tmp_path):
    """The C++ sparse-complement score provider (pgen_score_moments) is
    exactly equivalent to the dgemm path: flips (constant-base +
    corrections), both imputation modes, unused/monomorphic variants,
    full and UNSORTED subset cohorts."""
    from pgen_tpu.formats.writer import write_pgen
    from pgen_tpu.ops.score import score_native, score_numpy

    rng = np.random.default_rng(90)
    nv, ns, k = 50, 33, 2
    codes = rng.integers(0, 4, size=(nv, ns)).astype(np.uint8)
    codes[3] = 3  # all missing: unused, contributes nothing
    codes[6] = 0  # all hom-ref
    w = rng.normal(size=(nv, k))
    flip = rng.random(nv) < 0.5
    write_pgen(str(tmp_path / "s.pgen"), codes)
    rec = (2 * ns + 7) // 8
    packed = np.fromfile(
        str(tmp_path / "s.pgen"), dtype=np.uint8
    )[12:].reshape(nv, rec)
    for mi in (True, False):
        b = score_native(packed, ns, w, flip, mean_impute=mi)
        if b is None:
            pytest.skip("native runtime unavailable")
        a = score_numpy(packed, ns, w, flip, mean_impute=mi)
        np.testing.assert_allclose(b.sums, a.sums, rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(
            b.dosage_sum, a.dosage_sum, rtol=1e-12, atol=1e-10
        )
        np.testing.assert_array_equal(b.allele_ct, a.allele_ct)
        assert b.m_used == a.m_used
        idx = rng.permutation(ns)[:20].astype(np.int32)
        a2 = score_numpy(packed, ns, w, flip, mean_impute=mi,
                         sample_idx=idx)
        b2 = score_native(packed, ns, w, flip, mean_impute=mi,
                          sample_idx=idx)
        np.testing.assert_allclose(b2.sums, a2.sums, rtol=1e-12,
                                   atol=1e-10)
        np.testing.assert_array_equal(b2.allele_ct, a2.allele_ct)
    # duplicated sample indices fall back to the numpy path
    dup = np.array([0, 0, 1], dtype=np.int32)
    assert score_native(packed, ns, w, flip, sample_idx=dup) is None
