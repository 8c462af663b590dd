"""LD banded r² + window-greedy pruning (ops/ld.py, pipeline/prune.py)."""

import numpy as np
import pytest

from cli_helpers import run_cli
from conftest import build_fileset
from pgen_tpu.formats.writer import write_pgen
from pgen_tpu.ops.ld import (
    banded_r2_device,
    banded_r2_numpy,
    banded_r2_reference,
    centered_dosage_np,
    greedy_prune,
)
from pgen_tpu.pipeline.prune import parse_window_spec, prune, window_extents


def _pack(codes, tmp_path, name="ld"):
    path = str(tmp_path / f"{name}.pgen")
    write_pgen(path, codes)
    rec = (2 * codes.shape[1] + 7) // 8
    return np.fromfile(path, dtype=np.uint8)[12:].reshape(codes.shape[0], rec)


def _prune_oracle(codes, extents, step, thresh, maf):
    """Direct translation of the documented greedy spec."""
    c, norm = centered_dosage_np(codes)
    n = codes.shape[0]
    alive = np.ones(n, dtype=bool)
    for s in range(0, n, step):
        e = min(s + int(extents[s]), n)
        for i in range(s, e):
            for j in range(i + 1, e):
                if not (alive[i] and alive[j]):
                    continue
                den = norm[i] * norm[j]
                r2 = (c[i] @ c[j]) ** 2 / (den * den) if den > 0 else 0.0
                if r2 > thresh:
                    victim = i if maf[i] < maf[j] else j
                    alive[victim] = False
        if e >= n:
            break
    return alive


@pytest.mark.parametrize("shape,band", [((12, 5), 3), ((40, 9), 7), ((17, 4), 20)])
def test_banded_r2_numpy_matches_oracle(shape, band, tmp_path):
    rng = np.random.default_rng(shape[0])
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    codes[2] = 0  # monomorphic row: r2 must be 0 everywhere
    packed = _pack(codes, tmp_path)
    ref = banded_r2_reference(codes, band)
    got = banded_r2_numpy(packed, shape[1], band)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_banded_r2_device_matches_numpy(tmp_path):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(30, 7), dtype=np.uint8)
    packed = _pack(codes, tmp_path)
    ref = banded_r2_numpy(packed, 7, 6)
    got = banded_r2_device(packed, 7, 6)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    sel = np.array([0, 2, 5, 6], dtype=np.int32)
    ref_s = banded_r2_numpy(packed, 7, 6, sample_idx=sel)
    got_s = banded_r2_device(packed, 7, 6, sample_idx=sel)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-4, atol=1e-6)


def test_greedy_prune_removes_duplicate_keeps_higher_maf():
    # v1 == v0 (r2 = 1); v0 has the lower MAF -> v0 removed
    codes = np.array(
        [
            [0, 0, 1, 0, 0, 0],   # MAF low
            [0, 0, 1, 0, 0, 0],   # duplicate
            [1, 2, 0, 1, 2, 0],   # independent-ish
        ],
        dtype=np.uint8,
    ).repeat(4, axis=1)
    codes = np.vstack([codes[0], codes[0], codes[2]])
    # make row1 a higher-MAF duplicate pattern of row0: perturbation keeps
    # correlation 1 only if identical, so instead give row0/row1 equal
    # vectors and distinct MAFs via an extra hom-alt in row1? equal
    # vectors have equal MAF; use the tie rule: later variant removed.
    from pgen_tpu.ops.ld import banded_r2_reference as bref

    r2 = bref(codes, 2)
    maf = np.array([0.1, 0.1, 0.4])
    alive = greedy_prune(r2, maf, np.full(3, 3), 1, 0.5)
    assert alive.tolist() == [True, False, True]  # tie -> later removed


def test_greedy_prune_maf_rule():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 3, size=40, dtype=np.uint8)
    flipped = 2 - base  # r2 == 1 with base, same MAF profile mirrored
    codes = np.stack([base, flipped], axis=1).T.astype(np.uint8)
    codes = np.vstack([codes, rng.integers(0, 3, size=(1, 40), dtype=np.uint8)])
    r2 = banded_r2_reference(codes, 2)
    assert r2[0, 0] == pytest.approx(1.0)
    maf = np.array([0.3, 0.2, 0.25])
    alive = greedy_prune(r2, maf, np.full(3, 3), 1, 0.8)
    assert not alive[1] and alive[0]  # lower MAF loses


@pytest.mark.parametrize("seed", range(4))
def test_prune_pipeline_matches_oracle(seed, tmp_path):
    rng = np.random.default_rng(seed)
    nvar, ns = 25, 8
    codes = rng.integers(0, 4, size=(nvar, ns), dtype=np.uint8)
    # plant LD: several adjacent duplicate pairs
    for v in range(0, nvar - 1, 5):
        codes[v + 1] = codes[v]
    chroms = ["1"] * 15 + ["2"] * 10
    rows = [
        f"{chroms[i]}\t{100 + 7 * i}\trs{i}\tA\tG\t.\t.\t." for i in range(nvar)
    ]
    prefix = build_fileset(
        tmp_path, "pr", codes, rows, [f"s{i}\tM" for i in range(ns)]
    )
    res = prune(prefix, ["6", "2", "0.5"], out_prefix=str(tmp_path / "o"))
    chrom_b = np.array([c.encode() for c in chroms])
    extents = window_extents(chrom_b, None, 6, False)
    cnt = np.zeros((nvar, 4), dtype=np.int64)
    for k in range(4):
        cnt[:, k] = (codes == k).sum(axis=1)
    ac = cnt[:, 1] + 2 * cnt[:, 2]
    an = 2 * (cnt[:, 0] + cnt[:, 1] + cnt[:, 2])
    af = np.where(an > 0, ac / np.maximum(an, 1), 0.0)
    maf = np.minimum(af, 1 - af)
    expect = _prune_oracle(codes, extents, 2, 0.5, maf)
    np.testing.assert_array_equal(res.alive, expect)
    kept_ids = (tmp_path / "o.prune.in").read_text().split()
    assert kept_ids == [f"rs{i}" for i in np.flatnonzero(expect)]
    out_ids = (tmp_path / "o.prune.out").read_text().split()
    assert out_ids == [f"rs{i}" for i in np.flatnonzero(~expect)]


def test_prune_kb_windows_and_sort_requirement(tmp_path):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=(10, 6), dtype=np.uint8)
    codes[1] = codes[0]
    codes[5] = codes[4]
    pos = [100, 200, 5000, 5100, 5200, 5300, 9000, 9100, 9200, 9300]
    rows = [f"1\t{pos[i]}\trs{i}\tA\tG\t.\t.\t." for i in range(10)]
    prefix = build_fileset(
        tmp_path, "kb", codes, rows, [f"s{i}\tM" for i in range(6)]
    )
    res = prune(prefix, ["1kb", "1", "0.9"], out_prefix=str(tmp_path / "k"))
    assert not res.alive[1] or not res.alive[0]  # the duplicate pair pruned
    assert not res.alive[5] or not res.alive[4]
    # unsorted POS errors with guidance
    rows_bad = list(rows)
    rows_bad[0], rows_bad[1] = rows_bad[1], rows_bad[0]
    bad = build_fileset(
        tmp_path, "bad", codes, rows_bad, [f"s{i}\tM" for i in range(6)]
    )
    with pytest.raises(ValueError, match="sort"):
        prune(bad, ["1kb", "1", "0.9"], write=False)


def test_parse_window_spec():
    assert parse_window_spec(["50", "5", "0.2"]) == (50, False, 5, 0.2)
    assert parse_window_spec(["500kb", "1", "0.8"]) == (500, True, 1, 0.8)
    for bad in (["1", "5", "0.2"], ["50", "0", "0.2"], ["50", "5", "1.5"],
                ["x", "5", "0.2"]):
        with pytest.raises(ValueError):
            parse_window_spec(bad)


def test_cli_prune_provider_parity(tmp_path):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(30, 7), dtype=np.uint8)
    for v in range(0, 29, 4):
        codes[v + 1] = codes[v]
    rows = [f"1\t{100 + i}\trs{i}\tA\tG\t.\t.\t." for i in range(30)]
    prefix = build_fileset(
        tmp_path, "cp", codes, rows, [f"s{i}\tM" for i in range(7)]
    )
    outs = []
    for prov in ("numpy", "device"):
        out = str(tmp_path / prov)
        assert run_cli([
            "prune", prefix, "--indep-pairwise", "8", "3", "0.5",
            "-o", out, "--provider", prov,
        ]) == 0
        outs.append((tmp_path / f"{prov}.prune.in").read_text())
    assert outs[0] == outs[1]
