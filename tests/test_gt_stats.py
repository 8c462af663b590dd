"""Genotype-valued queries (GT_* stats) — the reference's wished-for
feature (README.md:259-264), implemented as numeric expression variables."""

import numpy as np
import pytest

from conftest import build_fileset
from pgen_tpu.formats.writer import pack_codes
from pgen_tpu.ops.gt_stats import (
    gt_counts,
    gt_counts_numpy,
    gt_counts_reference,
    gt_counts_subset,
    gt_variables,
)
from pgen_tpu.pipeline.filter import filter_to_vcf

from oracle import scalar_filter_vcf


@pytest.mark.parametrize("shape", [(3, 4), (10, 7), (20, 33)])
def test_counts_backends_agree(shape):
    rng = np.random.default_rng(shape[0])
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    packed = pack_codes(codes)
    ref = gt_counts_reference(packed, shape[1])
    assert (gt_counts_numpy(packed, shape[1]) == ref).all()
    assert (gt_counts(packed, shape[1], provider="native") == ref).all()
    assert (gt_counts(packed, shape[1], provider="device") == ref).all()
    # histogram sums to the sample count (pad positions excluded)
    assert (ref.sum(axis=1) == shape[1]).all()


def test_counts_subset():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(12, 21), dtype=np.uint8)
    packed = pack_codes(codes)
    idx = np.array([0, 3, 4, 11, 20], dtype=np.int32)
    got = gt_counts_subset(packed, idx)
    sub = codes[:, idx]
    for k in range(4):
        assert (got[:, k] == (sub == k).sum(axis=1)).all()
    # numpy fallback agrees
    import pgen_tpu.ops.gt_stats as gs

    lut_based = gs.gt_counts_subset(packed, idx, provider="numpy")
    assert (lut_based == got).all()


def test_gt_variables():
    counts = np.array([[5, 2, 1, 2]], dtype=np.int64)
    v = gt_variables(counts, 10)
    assert v["GT_HOMREF"][0] == 5
    assert v["GT_AC"][0] == 2 + 2 * 1
    assert v["GT_NOBS"][0] == 8


@pytest.fixture()
def gt_fileset(tmp_path):
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 4, size=(30, 9), dtype=np.uint8)
    codes[0, :] = 3  # all missing
    codes[1, :] = 0  # all hom-ref
    prefix = build_fileset(
        tmp_path,
        "gt",
        codes,
        [f"1\t{100 + i}\tr{i}\tA\tC\t.\t.\t." for i in range(30)],
        [f"s{i}\tM" for i in range(9)],
    )
    return prefix, codes


def test_filter_by_missing_count(gt_fileset, tmp_path):
    prefix, codes = gt_fileset
    out = tmp_path / "m.vcf"
    res = filter_to_vcf(prefix, var_query="GT_MISSING == 9", out_file=out)
    keep = (codes == 3).sum(axis=1) == 9
    expected = scalar_filter_vcf(
        prefix, lambda v: keep[int(v["ID"][1:])], None
    )
    assert out.read_bytes() == expected
    assert res.num_variants_kept == int(keep.sum())


def test_filter_by_allele_count_and_metadata(gt_fileset, tmp_path):
    prefix, codes = gt_fileset
    out = tmp_path / "ac.vcf"
    ac = (codes == 1).sum(axis=1) + 2 * (codes == 2).sum(axis=1)
    res = filter_to_vcf(
        prefix,
        var_query='GT_AC >= 8 && REF == "A"',
        out_file=out,
    )
    keep = ac >= 8
    assert res.num_variants_kept == int(keep.sum())
    expected = scalar_filter_vcf(prefix, lambda v: keep[int(v["ID"][1:])], None)
    assert out.read_bytes() == expected


def test_gt_stats_cohort_aware(gt_fileset, tmp_path):
    """With a sample subset, GT_* counts cover only the kept cohort."""
    prefix, codes = gt_fileset
    out = tmp_path / "c.vcf"
    kept_s = [0, 2, 5]
    q = " || ".join(f'IID=="s{i}"' for i in kept_s)
    res = filter_to_vcf(
        prefix,
        var_query="GT_MISSING == 0",
        sam_query=q,
        out_file=out,
    )
    sub = codes[:, kept_s]
    keep = (sub == 3).sum(axis=1) == 0
    assert res.num_variants_kept == int(keep.sum())
    expected = scalar_filter_vcf(
        prefix,
        lambda v: keep[int(v["ID"][1:])],
        lambda s: int(s["IID"][1:]) in kept_s,
    )
    assert out.read_bytes() == expected


def test_gt_float_arithmetic(gt_fileset, tmp_path):
    """Missing-rate style expressions: int col / int literal stays Int
    (truncating), so use float literals for rates."""
    prefix, codes = gt_fileset
    out = tmp_path / "f.vcf"
    res = filter_to_vcf(
        prefix, var_query="GT_MISSING * 10 < GT_NOBS", out_file=out
    )
    missing = (codes == 3).sum(axis=1)
    keep = missing * 10 < (9 - missing)
    assert res.num_variants_kept == int(keep.sum())


def test_gt_numeric_semantics(gt_fileset, tmp_path):
    prefix, codes = gt_fileset
    # Int col vs Float literal is variant-tagged: never equal
    res = filter_to_vcf(
        prefix, var_query="GT_MISSING == 0.0", out_file=tmp_path / "x.vcf"
    )
    assert res.num_variants_kept == 0
    # ordering promotes: works against floats
    res2 = filter_to_vcf(
        prefix, var_query="GT_MISSING < 0.5", out_file=tmp_path / "y.vcf"
    )
    assert res2.num_variants_kept == int(((codes == 3).sum(axis=1) == 0).sum())
    # ordering against a string errors
    with pytest.raises(Exception, match="number"):
        filter_to_vcf(prefix, var_query='GT_MISSING < "2"', out_file=tmp_path / "z.vcf")


def test_gt_in_sharded_and_pgen_out(gt_fileset, tmp_path):
    from pgen_tpu.formats.header import read_pgen_header
    from pgen_tpu.parallel.shard import filter_to_vcf_sharded
    from pgen_tpu.pipeline.pgen_out import filter_to_pgen

    prefix, codes = gt_fileset
    a = tmp_path / "a.vcf"
    b = tmp_path / "b.vcf"
    filter_to_vcf(prefix, var_query="GT_AC >= 8", out_file=a)
    filter_to_vcf_sharded(prefix, var_query="GT_AC >= 8", out_file=b, num_shards=3)
    assert a.read_bytes() == b.read_bytes()

    res = filter_to_pgen(prefix, var_query="GT_AC >= 8", out_prefix=str(tmp_path / "p"))
    h = read_pgen_header(tmp_path / "p.pgen")
    ac = (codes == 1).sum(axis=1) + 2 * (codes == 2).sum(axis=1)
    assert h.num_variants == int((ac >= 8).sum())


def test_gt_query_with_parallel_workers(gt_fileset, tmp_path):
    from pgen_tpu.parallel.shard import filter_to_vcf_parallel

    prefix, codes = gt_fileset
    a = tmp_path / "a.vcf"
    b = tmp_path / "b.vcf"
    filter_to_vcf(prefix, var_query="GT_AC >= 8", out_file=a)
    res = filter_to_vcf_parallel(
        prefix, var_query="GT_AC >= 8", out_file=b, num_workers=2
    )
    assert a.read_bytes() == b.read_bytes()
    ac = (codes == 1).sum(axis=1) + 2 * (codes == 2).sum(axis=1)
    assert res.num_variants_kept == int((ac >= 8).sum())


class TestSampleCounts:
    """Per-sample histogram (the column-axis reduction)."""

    def _codes(self, nv=9, ns=13, seed=3):
        rng = np.random.default_rng(seed)
        codes = rng.integers(0, 4, size=(nv, ns), dtype=np.uint8)
        from pgen_tpu.formats.writer import pack_codes

        return codes, pack_codes(codes)

    def test_reference_oracle(self):
        from pgen_tpu.ops.gt_stats import sample_counts_reference

        codes, packed = self._codes()
        sc = sample_counts_reference(packed, codes.shape[1])
        for s in range(codes.shape[1]):
            for k in range(4):
                assert sc[s, k] == int((codes[:, s] == k).sum())

    @pytest.mark.parametrize("ns", [1, 4, 5, 8, 13])
    def test_providers_match_oracle(self, ns):
        from pgen_tpu.ops.gt_stats import (
            sample_counts,
            sample_counts_device,
            sample_counts_numpy,
            sample_counts_reference,
        )

        codes, packed = self._codes(ns=ns)
        ref = sample_counts_reference(packed, ns)
        assert np.array_equal(sample_counts_numpy(packed, ns), ref)
        assert np.array_equal(sample_counts(packed, ns, "native"), ref)
        assert np.array_equal(
            np.asarray(sample_counts_device(packed, ns)), ref
        )

    def test_pad_bits_excluded(self):
        # poisoned pad bits must not leak into any sample's counts
        from pgen_tpu.formats.writer import pack_codes
        from pgen_tpu.ops.gt_stats import sample_counts, sample_counts_numpy

        codes = np.zeros((3, 5), dtype=np.uint8)
        packed = pack_codes(codes)
        packed[:, -1] |= 0b11111100 & ~0b11  # junk in the 3 pad slots
        for impl in (sample_counts_numpy, lambda p, n: sample_counts(p, n, "native")):
            sc = impl(packed, 5)
            assert sc[:, 0].sum() == 15  # all-zero codes, 5 samples x 3 vars
            assert sc.sum() == 15

    def test_cli_per_sample(self, tiny_fileset, capsys):
        from tests.cli_helpers import run_cli

        prefix, codes = tiny_fileset
        rc = run_cli(["stats", prefix, "--per-sample"])
        assert rc == 0
        lines = capsys.readouterr().out.splitlines()
        hdr = [i for i, l in enumerate(lines) if l.startswith("#IID")]
        assert len(hdr) == 1
        rows = lines[hdr[0] + 1 :]
        assert len(rows) == codes.shape[1]
        first = rows[0].split("\t")
        assert first[0] == "s0"
        assert int(first[1]) == int((codes[:, 0] == 0).sum())
        assert int(first[4]) == int((codes[:, 0] == 3).sum())

    def test_cli_per_sample_cohort_and_regions(self, tiny_fileset, capsys):
        from tests.cli_helpers import run_cli

        prefix, codes = tiny_fileset
        rc = run_cli(
            ["stats", prefix, "--per-sample", "-r", "1:101-103", "--include-sam", 'IID=="s2"']
        )
        assert rc == 0
        lines = capsys.readouterr().out.splitlines()
        rows = lines[lines.index(next(l for l in lines if l.startswith("#IID"))) + 1 :]
        assert len(rows) == 1
        f = rows[0].split("\t")
        sub = codes[1:4, 2]  # variants at POS 101..103, sample s2
        assert f[0] == "s2"
        assert int(f[1]) == int((sub == 0).sum())
        assert int(f[4]) == int((sub == 3).sum())
