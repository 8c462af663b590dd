"""IBD sharing (`genome`): op providers vs brute-force oracle, IBS
identities, method-of-moments sanity on simulated pedigrees, mesh psum
path, and the CLI table surface."""

import numpy as np
import pytest

from tests.cli_helpers import run_cli
from tests.conftest import build_fileset

from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops.ibd import (
    ibd_counts_device,
    ibd_counts_numpy,
    ibd_counts_reference,
    ibd_estimates,
    ibs_from_counts,
)


def _pack(codes: np.ndarray, tmp_path, name="g") -> np.ndarray:
    path = str(tmp_path / f"{name}.pgen")
    write_pgen(path, codes)
    ns = codes.shape[1]
    rec = (2 * ns + 7) // 8
    mm = np.fromfile(path, dtype=np.uint8)
    return mm[12:].reshape(codes.shape[0], rec)


@pytest.mark.parametrize("shape", [(1, 2), (7, 5), (50, 4), (33, 17)])
def test_numpy_matches_oracle(shape, tmp_path):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    ref = ibd_counts_reference(codes)
    got = ibd_counts_numpy(packed, shape[1], block_variants=8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(7, 5), (65, 13)])
def test_device_matches_oracle(shape, tmp_path):
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    ref = ibd_counts_reference(codes)
    got = ibd_counts_device(packed, shape[1], block_variants=16)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_device_sample_subset(tmp_path):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(40, 11), dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    sel = np.array([0, 3, 4, 9, 10], dtype=np.int32)
    ref = ibd_counts_reference(codes[:, sel])
    got = ibd_counts_device(
        packed, 11, block_variants=16, sample_idx=sel
    )
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    got_np = ibd_counts_numpy(packed, 11, sample_idx=sel)
    for a, b in zip(got_np, ref):
        np.testing.assert_array_equal(a, b)


def test_ibs_identities():
    """IBS0+IBS1+IBS2 == NSNP and classifications match a direct count."""
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=(80, 6), dtype=np.uint8)
    counts = ibd_counts_reference(codes)
    ibs0, ibs1, ibs2 = ibs_from_counts(counts)
    np.testing.assert_array_equal(ibs0 + ibs1 + ibs2, counts.nsnp)
    i, j = 2, 5
    ci, cj = codes[:, i], codes[:, j]
    both = (ci != 3) & (cj != 3)
    assert ibs2[i, j] == np.sum(both & (ci == cj))
    assert ibs0[i, j] == np.sum(
        both & (((ci == 0) & (cj == 2)) | ((ci == 2) & (cj == 0)))
    )
    # diagonal: every called variant is IBS2 with itself
    np.testing.assert_array_equal(np.diag(ibs2), np.diag(counts.nsnp))


def test_mesh_psum_matches_oracle(tmp_path):
    import jax

    from pgen_tpu.ops.ibd import build_ibd_mesh_step
    from pgen_tpu.parallel.mesh import make_mesh, pad_to_multiple

    ndev = len(jax.devices())
    assert ndev == 8, "conftest forces an 8-device CPU platform"
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(53, 6), dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    ref = ibd_counts_reference(codes)
    mesh = make_mesh()
    padded = pad_to_multiple(packed, ndev)
    padded[packed.shape[0]:] = 0xFF
    step = build_ibd_mesh_step(mesh, num_samples=6, block_variants=4)
    got = step(padded)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float64), b)


def _simulate_family(v, seed=0, p=0.5):
    """mother, father unrelated under HWE(p); child gets one transmitted
    allele from each; plus a duplicate of the mother. Codes are ALT
    counts (0/1/2), no missing."""
    rng = np.random.default_rng(seed)
    mom = rng.binomial(1, p, size=(v, 2))  # phased allele pairs
    dad = rng.binomial(1, p, size=(v, 2))
    child = np.stack(
        [mom[np.arange(v), rng.integers(0, 2, v)],
         dad[np.arange(v), rng.integers(0, 2, v)]], axis=1
    )
    codes = np.stack(
        [mom.sum(1), dad.sum(1), child.sum(1), mom.sum(1)], axis=1
    ).astype(np.uint8)
    return codes  # samples: mom, dad, child, mom-dup


def test_mom_pedigree_estimates():
    codes = _simulate_family(6000, seed=23)
    counts = ibd_counts_reference(codes)
    af = codes.mean(axis=1) / 2.0
    est = ibd_estimates(counts, af)
    pi = est["pi_hat"]
    # parent-offspring shares exactly one allele IBD: PI_HAT ~ 0.5, Z1 ~ 1
    assert pi[0, 2] == pytest.approx(0.5, abs=0.06)
    assert pi[1, 2] == pytest.approx(0.5, abs=0.06)
    assert est["z1"][0, 2] == pytest.approx(1.0, abs=0.12)
    # duplicate pair: no IBS0/IBS1 possible -> Z2 = PI_HAT = 1 exactly
    assert est["ibs0"][0, 3] == 0
    assert pi[0, 3] == pytest.approx(1.0, abs=1e-9)
    # unrelated pair: PI_HAT ~ 0 (clamped at 0 from below)
    assert pi[0, 1] == pytest.approx(0.0, abs=0.08)
    # DST bounds and symmetry
    assert np.all((est["dst"] >= 0) & (est["dst"] <= 1))
    np.testing.assert_allclose(pi, pi.T)


def test_estimates_degenerate_cases():
    # zero-NSNP pair -> all-NaN row; monomorphic-only -> NaN Zs
    codes = np.array([[1, 3], [3, 1]], dtype=np.uint8)
    est = ibd_estimates(ibd_counts_reference(codes), np.array([0.5, 0.5]))
    assert np.isnan(est["pi_hat"][0, 1]) and np.isnan(est["dst"][0, 1])
    codes = np.array([[0, 0], [0, 0]], dtype=np.uint8)
    est = ibd_estimates(ibd_counts_reference(codes), np.array([0.0, 0.0]))
    assert np.isnan(est["z0"][0, 1])  # m00 == 0: no information
    assert est["dst"][0, 1] == 1.0  # DST itself is still defined


def _genome_fileset(tmp_path, codes):
    nvar, ns = codes.shape
    pvar_rows = [
        f"1\t{100 + i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nvar)
    ]
    psam_rows = [f"s{i}\t{'F' if i % 2 else 'M'}" for i in range(ns)]
    return build_fileset(tmp_path, "gen", codes, pvar_rows, psam_rows)


def test_cli_genome_table(tmp_path):
    codes = _simulate_family(400, seed=7)
    prefix = _genome_fileset(tmp_path, codes)
    out = tmp_path / "t.genome"
    assert run_cli(["genome", prefix, "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0] == ("#IID1\tIID2\tNSNP\tIBS0\tIBS1\tIBS2\tDST\t"
                        "Z0\tZ1\tZ2\tPI_HAT")
    ns = 4
    assert len(lines) - 1 == ns * (ns - 1) // 2
    rows = {tuple(r.split("\t")[:2]): r.split("\t") for r in lines[1:]}
    dup = rows[("s0", "s3")]
    assert int(dup[3]) == 0 and float(dup[10]) == pytest.approx(1.0)
    assert int(dup[2]) == 400
    po = rows[("s0", "s2")]
    assert float(po[10]) == pytest.approx(0.5, abs=0.15)


def test_cli_genome_min_pi_hat_and_subset(tmp_path):
    codes = _simulate_family(300, seed=9)
    prefix = _genome_fileset(tmp_path, codes)
    out = tmp_path / "f.genome"
    assert run_cli([
        "genome", prefix, "-o", str(out), "--min-pi-hat", "0.9",
    ]) == 0
    body = [l.split("\t") for l in out.read_text().splitlines()[1:]]
    assert [r[:2] for r in body] == [["s0", "s3"]]
    out2 = tmp_path / "s.genome"
    assert run_cli([
        "genome", prefix, "-o", str(out2), "--samples", "s0,s1,s2",
    ]) == 0
    assert len(out2.read_text().splitlines()) == 1 + 3


def test_cli_genome_provider_parity(tmp_path):
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=(25, 7), dtype=np.uint8)
    prefix = _genome_fileset(tmp_path, codes)
    texts = []
    for prov in ("numpy", "device"):
        out = tmp_path / f"{prov}.genome"
        assert run_cli(
            ["genome", prefix, "-o", str(out), "--provider", prov]
        ) == 0
        texts.append(out.read_text())
    assert texts[0] == texts[1]
