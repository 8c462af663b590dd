"""KING-robust kinship: op providers vs brute-force oracle, known values,
mesh psum path, and the CLI table surface."""

import numpy as np
import pytest

from tests.cli_helpers import run_cli
from tests.conftest import build_fileset

from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops.king import (
    KingCounts,
    king_counts_device,
    king_counts_numpy,
    king_counts_reference,
    king_kinship,
)


def _pack(codes: np.ndarray, tmp_path, name="k") -> np.ndarray:
    """Write codes through the real 2-bit packer and mmap the records back
    so tests cover the packed-domain (incl. last-byte pad) path."""
    path = str(tmp_path / f"{name}.pgen")
    write_pgen(path, codes)
    ns = codes.shape[1]
    rec = (2 * ns + 7) // 8
    mm = np.fromfile(path, dtype=np.uint8)
    return mm[12:].reshape(codes.shape[0], rec)


@pytest.mark.parametrize("shape", [(1, 2), (7, 5), (50, 4), (33, 17), (64, 9)])
def test_numpy_matches_oracle(shape, tmp_path):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    ref = king_counts_reference(codes)
    got = king_counts_numpy(packed, shape[1], block_variants=8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(7, 5), (65, 13)])
def test_device_matches_oracle(shape, tmp_path):
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    ref = king_counts_reference(codes)
    got = king_counts_device(packed, shape[1], block_variants=16)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_device_sample_subset(tmp_path):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(40, 11), dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    sel = np.array([0, 3, 4, 9, 10], dtype=np.int32)
    ref = king_counts_reference(codes[:, sel])
    got = king_counts_device(
        packed, 11, block_variants=16, sample_idx=sel
    )
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    got_np = king_counts_numpy(packed, 11, sample_idx=sel)
    for a, b in zip(got_np, ref):
        np.testing.assert_array_equal(a, b)


def test_known_values_duplicates_and_opposites():
    # s0 == s1 (MZ twins): kinship exactly 0.5.
    # s2 is s0 with hom calls flipped: maximal IBS0, strongly negative.
    v = 60
    rng = np.random.default_rng(9)
    base = rng.integers(0, 3, size=v, dtype=np.uint8)  # no missing
    flip = base.copy()
    flip[base == 0] = 2
    flip[base == 2] = 0
    codes = np.stack([base, base, flip], axis=1)
    counts = king_counts_reference(codes)
    kin, ibs0 = king_kinship(counts)
    n_het = int((base == 1).sum())
    n_hom = v - n_het
    assert kin[0, 1] == pytest.approx(0.5)
    np.testing.assert_array_equal(ibs0[0, 1], 0)
    np.testing.assert_array_equal(ibs0[0, 2], n_hom)
    # hethet(0,2)=n_het, den = 2*n_het
    assert kin[0, 2] == pytest.approx((n_het - 2 * n_hom) / (2 * n_het))


def test_missing_pairwise_complete():
    # Missing calls restrict counts to both-called variants only.
    codes = np.array(
        [
            [1, 1],
            [1, 3],  # s1 missing: excluded from every pair count
            [3, 1],  # s0 missing
            [0, 2],
            [1, 1],
        ],
        dtype=np.uint8,
    )
    counts = king_counts_reference(codes)
    assert counts.nsnp[0, 1] == 3
    assert counts.hethet[0, 1] == 2
    assert counts.ra[0, 1] == 1
    assert counts.hetcal[0, 1] == 2  # s0 het & s1 called: rows 0, 4
    kin, ibs0 = king_kinship(counts)
    assert ibs0[0, 1] == 1
    assert kin[0, 1] == pytest.approx((2 - 2 * 1) / (2 + 2))


def test_zero_denominator_is_nan():
    codes = np.array([[0, 0], [2, 2]], dtype=np.uint8)  # nobody het
    kin, _ = king_kinship(king_counts_reference(codes))
    assert np.isnan(kin[0, 1])


def test_mesh_psum_matches_single_device(tmp_path):
    import jax

    from pgen_tpu.ops.king import build_king_mesh_step
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    ndev = len(jax.devices())
    assert ndev == 8, "conftest forces an 8-device CPU platform"
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(53, 6), dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    ref = king_counts_reference(codes)
    mesh = make_mesh()
    # pad with 0xFF (all-missing) rows so the variant axis divides the mesh
    padded = pad_to_multiple(packed, ndev)
    padded[packed.shape[0]:] = 0xFF
    step = build_king_mesh_step(mesh, num_samples=6, block_variants=4)
    got = step(padded)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float64), b)


def _king_fileset(tmp_path, codes):
    nvar, ns = codes.shape
    pvar_rows = [
        f"1\t{100 + i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nvar)
    ]
    psam_rows = [f"s{i}\t{'F' if i % 2 else 'M'}" for i in range(ns)]
    return build_fileset(tmp_path, "kin", codes, pvar_rows, psam_rows)


def test_cli_king_table(tmp_path, capsys):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(30, 5), dtype=np.uint8)
    codes[:, 1] = codes[:, 0]  # duplicate pair
    prefix = _king_fileset(tmp_path, codes)
    out = tmp_path / "t.kin0"
    assert run_cli(["king", prefix, "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == "#IID1\tIID2\tNSNP\tHETHET\tIBS0\tKINSHIP"
    ns = 5
    assert len(lines) - 1 == ns * (ns - 1) // 2
    # first pair is the duplicate: kinship 0.5 (if any het, both called)
    row = dict(zip(lines[0].lstrip("#").split("\t"), lines[1].split("\t")))
    assert row["IID1"] == "s0" and row["IID2"] == "s1"
    ref = king_counts_reference(codes)
    kin, _ = king_kinship(ref)
    assert float(row["KINSHIP"]) == pytest.approx(kin[0, 1], abs=5e-7)
    assert int(row["NSNP"]) == int(ref.nsnp[0, 1])


def test_cli_king_min_kinship_and_subsets(tmp_path):
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, size=(40, 6), dtype=np.uint8)
    codes[:, 2] = codes[:, 4]  # related pair among kept samples
    prefix = _king_fileset(tmp_path, codes)
    out = tmp_path / "f.kin0"
    assert run_cli([
        "king", prefix, "-o", str(out),
        "--samples", "s2,s4,s5", "--min-kinship", "0.4",
    ]) == 0
    lines = out.read_text().splitlines()
    body = [l.split("\t") for l in lines[1:]]
    assert [r[:2] for r in body] == [["s2", "s4"]]
    assert float(body[0][5]) >= 0.4
    # variant predicate restricts the counted variants
    out2 = tmp_path / "g.kin0"
    assert run_cli([
        "king", prefix, "-o", str(out2), "--include-var", 'POS!="100"',
    ]) == 0
    ref = king_counts_reference(codes[1:])
    first = out2.read_text().splitlines()[1].split("\t")
    assert int(first[2]) == int(ref.nsnp[0, 1])


def test_cli_king_provider_parity(tmp_path):
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=(25, 7), dtype=np.uint8)
    prefix = _king_fileset(tmp_path, codes)
    texts = []
    for prov in ("numpy", "device"):
        out = tmp_path / f"{prov}.kin0"
        assert run_cli(["king", prefix, "-o", str(out), "--provider", prov]) == 0
        texts.append(out.read_text())
    assert texts[0] == texts[1]


def test_cli_king_rejects_single_sample(tmp_path):
    codes = np.array([[0], [1]], dtype=np.uint8)
    prefix = build_fileset(
        tmp_path, "one", codes, ["1\t100\trs0\tA\tG\t.\t.\t."], ["s0\tM"]
    )
    assert run_cli(["king", prefix]) == 1


def test_king_cutoff_mask_greedy():
    from pgen_tpu.pipeline.king import king_cutoff_mask

    # s1 related to s0 and s2; removing s1 resolves everything
    kin = np.full((3, 3), -0.1)
    kin[0, 1] = kin[1, 0] = 0.3
    kin[1, 2] = kin[2, 1] = 0.3
    keep = king_cutoff_mask(kin, 0.177)
    assert keep.tolist() == [True, False, True]
    # tie (one pair): the LATER member is removed
    kin2 = np.full((2, 2), 0.5)
    assert king_cutoff_mask(kin2, 0.177).tolist() == [True, False]
    # NaN never counts
    kin3 = np.full((2, 2), np.nan)
    assert king_cutoff_mask(kin3, 0.177).tolist() == [True, True]


def test_cli_king_cutoff(tmp_path):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 3, size=(60, 5), dtype=np.uint8)
    codes[:, 3] = codes[:, 1]  # duplicate pair s1/s3 -> kinship 0.5
    prefix = _king_fileset(tmp_path, codes)
    out = str(tmp_path / "kc")
    assert run_cli(["king", prefix, "--cutoff", "0.354", "-o", out]) == 0
    kept = (tmp_path / "kc.king.cutoff.in.id").read_text().split()
    dropped = (tmp_path / "kc.king.cutoff.out.id").read_text().split()
    assert dropped == ["s3"]  # tie between s1/s3 -> later removed
    assert kept == ["s0", "s1", "s2", "s4"]
