"""Device decode/encode (plain jnp, run here on the CPU backend) vs scalar
oracles (SURVEY.md C10 + the gt-text/pack twins)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pgen_tpu.ops.gt_text import (
    genotype_text,
    genotype_text_from_codes,
    genotype_text_reference,
)
from pgen_tpu.ops.pack import pack_codes_device
from pgen_tpu.ops.unpack import unpack_codes, unpack_codes_reference


@pytest.mark.parametrize("shape", [(4, 5), (33, 128), (100, 2504)])
def test_unpack_matches_oracle(shape):
    nvar, nsamp = shape
    rec = (2 * nsamp + 7) // 8
    rng = np.random.default_rng(nvar)
    packed = rng.integers(0, 256, size=(nvar, rec), dtype=np.uint8)
    ref = unpack_codes_reference(packed, nsamp)
    got = np.asarray(unpack_codes(jnp.asarray(packed), nsamp))
    assert (got == ref).all()


def test_unpack_lsb_first():
    # byte 0b00_11_10_01 -> samples [1, 2, 3, 0] (pfile.rs:171-175)
    packed = np.array([[0b00111001]], dtype=np.uint8)
    got = np.asarray(unpack_codes(jnp.asarray(packed), 4))
    assert got.tolist() == [[1, 2, 3, 0]]


def test_unpack_all_256_bytes_exhaustive():
    """The multiply-spread word formula equals the reference bit extraction
    for every possible packed byte."""
    packed = np.arange(256, dtype=np.uint8).reshape(1, 256)
    ref = unpack_codes_reference(packed, 1024)
    got = np.asarray(unpack_codes(jnp.asarray(packed), 1024))
    assert (got == ref).all()


@pytest.mark.parametrize("shape", [(3, 4), (17, 30), (64, 2504)])
def test_pack_unpack_roundtrip(shape):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    packed = np.asarray(pack_codes_device(jnp.asarray(codes)))
    assert (unpack_codes_reference(packed, shape[1]) == codes).all()
    # also matches the host writer's packing exactly
    from pgen_tpu.formats.writer import pack_codes

    assert (packed == pack_codes(codes)).all()


def test_text_tokens():
    codes = np.array([[0, 1, 2, 3]], dtype=np.uint8)
    got = np.asarray(genotype_text_from_codes(jnp.asarray(codes)))
    assert got.tobytes() == b"\t0/0\t0/1\t1/1\t./."


@pytest.mark.parametrize("shape", [(5, 7), (40, 301), (16, 2504)])
def test_fused_text_matches_oracle(shape):
    nvar, nsamp = shape
    rec = (2 * nsamp + 7) // 8
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 256, size=(nvar, rec), dtype=np.uint8)
    codes = unpack_codes_reference(packed, nsamp)
    ref = genotype_text_reference(codes)
    got = np.asarray(genotype_text(jnp.asarray(packed), nsamp))
    assert got.shape == ref.shape
    assert (got == ref).all()


def test_text_from_codes_matches_fused():
    rng = np.random.default_rng(2)
    nvar, nsamp = 13, 21
    rec = (2 * nsamp + 7) // 8
    packed = rng.integers(0, 256, size=(nvar, rec), dtype=np.uint8)
    codes = unpack_codes_reference(packed, nsamp)
    a = np.asarray(genotype_text(jnp.asarray(packed), nsamp))
    b = np.asarray(genotype_text_from_codes(jnp.asarray(codes)))
    assert (a == b).all()


def test_native_matches_oracle():
    from pgen_tpu.native import HAVE_NATIVE, native

    if not HAVE_NATIVE:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(3)
    nvar, nsamp = 29, 37
    rec = (2 * nsamp + 7) // 8
    packed = rng.integers(0, 256, size=(nvar, rec), dtype=np.uint8)
    ref = unpack_codes_reference(packed, nsamp)
    assert (native.unpack_codes(packed, nsamp) == ref).all()
    assert (native.pack_codes(ref) == np.asarray(
        pack_codes_device(jnp.asarray(ref))
    )).all()


@pytest.mark.parametrize("nsamp", [1, 3, 5, 17, 2503])
def test_planes_interleave_match_oracle_odd_samples(nsamp):
    """Plane-form text (device planes + host interleave) equals the oracle
    when the sample count leaves a partial tail byte."""
    from pgen_tpu.ops.gt_text import interleave_planes_numpy, planes_from_packed

    nvar = 7
    rec = (2 * nsamp + 7) // 8
    rng = np.random.default_rng(nsamp)
    packed = rng.integers(0, 256, size=(nvar, rec), dtype=np.uint8)
    ref = genotype_text_reference(unpack_codes_reference(packed, nsamp))
    planes = planes_from_packed(jnp.asarray(packed))
    got = interleave_planes_numpy(planes, 4 * nsamp)
    assert got.shape == ref.shape
    assert (got == ref).all()


def test_subset_text_from_packed_matches_oracle():
    """Device-side kept-sample gather (the subset d2h shrinker) must equal
    the oracle's column slice for arbitrary subsets, incl. empty/all."""
    from pgen_tpu.ops.gt_text import subset_text_from_packed

    rng = np.random.default_rng(11)
    nvar, nsamp = 23, 61
    rec = (2 * nsamp + 7) // 8
    packed = rng.integers(0, 256, size=(nvar, rec), dtype=np.uint8)
    ref = genotype_text_reference(unpack_codes_reference(packed, nsamp))
    for sel in (
        np.array([0]),
        np.array([3, 4, 60]),
        rng.choice(nsamp, 17, replace=False),
        np.arange(nsamp),
        np.array([], dtype=np.int64),
    ):
        got = subset_text_from_packed(jnp.asarray(packed), sel)
        want = ref.reshape(nvar, nsamp, 4)[:, sel].reshape(nvar, -1)
        assert got.shape == want.shape and (got == want).all(), sel
