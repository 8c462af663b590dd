"""Filter to a .pgen fileset (pgen -> pgen), not just VCF.

The reference lists .pgen output as future work
(/root/reference/README.md:217-219); the pack kernel (ops/pack.py,
native pgen_pack_codes) makes it a straightforward pipeline here:

  variants: mask -> contiguous row gather of packed records (no re-coding
            needed when all samples are kept — records are copied verbatim)
  samples:  subsetting re-packs: unpack block -> gather kept sample
            columns -> pack (native C++ or device kernels)
  metadata: kept .pvar/.psam rows pass through byte-exactly (comments and
            the '#' column line included)

Output: OUT_PREFIX.pgen / .pvar / .psam, a valid mode-0x02 fileset readable
by this tool and by plink2.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from pgen_tpu.formats.header import (
    FIXED_WIDTH_STORAGE_MODE,
    MODE2_FORMAT_BYTE,
    PGEN_MAGIC,
    read_pgen_header,
    variant_record_size,
)
from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.pipeline.filter import _gather_rows, _resolve_provider
from pgen_tpu.utils.timer import StageTimer

DEFAULT_BLOCK = 1 << 16


@dataclass
class PgenFilterResult:
    out_prefix: str
    num_variants_kept: int
    num_samples_kept: int
    timer: StageTimer


def _subset_block(packed_blk, sam_idx, n_total_samples, provider):
    """Re-pack a block of records to only the kept sample columns."""
    if provider == "device":
        import jax.numpy as jnp

        from pgen_tpu.ops.pack import pack_codes_device
        from pgen_tpu.ops.unpack import unpack_codes
        from pgen_tpu.pipeline.device import device_backend

        device_backend()
        codes = unpack_codes(jnp.asarray(packed_blk), n_total_samples)
        sub = codes[:, jnp.asarray(sam_idx)]
        return np.asarray(pack_codes_device(sub))
    from pgen_tpu.native import HAVE_NATIVE, native

    if provider == "native" and HAVE_NATIVE:
        codes = native.unpack_codes(packed_blk, n_total_samples)
        return native.pack_codes(np.ascontiguousarray(codes[:, sam_idx]))
    from pgen_tpu.formats.writer import pack_codes
    from pgen_tpu.ops.unpack_host import unpack_codes_reference

    codes = unpack_codes_reference(packed_blk, n_total_samples)
    return pack_codes(codes[:, sam_idx])


def _write_meta_subset(src_table, idx, out_path, include_comments=True):
    """Write kept metadata rows byte-exactly (comments + header + rows)."""
    starts, ends = src_table.row_line_spans()
    with open(out_path, "wb") as f:
        if include_comments:
            f.write(src_table.comments.encode("utf-8"))
        f.write(src_table.header_line.encode("utf-8"))
        f.write(b"\n")
        buf = src_table.data_buffer
        for i in idx:
            f.write(buf[starts[i] : ends[i]].tobytes())
            f.write(b"\n")


def filter_to_pgen(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_prefix: str | None = None,
    provider: str = "auto",
    block_variants: int = DEFAULT_BLOCK,
) -> PgenFilterResult:
    provider = _resolve_provider(provider)
    timer = StageTimer()
    if out_prefix is None:
        out_prefix = f"{pfile_prefix}.pgen-rs"
    out_prefix = str(out_prefix)

    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")

    rec = header.record_size
    pgen_mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = pgen_mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )

    from pgen_tpu.pipeline.filter import compute_masks

    with timer.stage("predicates"):
        var_mask, sam_mask = compute_masks(
            var_query, sam_query, pvar, psam, header, records, provider
        )
    var_idx = np.flatnonzero(var_mask)
    sam_idx = np.flatnonzero(sam_mask)
    n_kept = len(sam_idx)
    keep_all_samples = n_kept == psam.num_rows == header.num_samples
    out_rec = rec if keep_all_samples else variant_record_size(n_kept)

    with timer.stage("write_pgen"):
        with open(f"{out_prefix}.pgen", "wb") as f:
            f.write(PGEN_MAGIC)
            f.write(bytes([FIXED_WIDTH_STORAGE_MODE]))
            f.write(struct.pack("<II", len(var_idx), n_kept))
            f.write(bytes([MODE2_FORMAT_BYTE]))
            for lo in range(0, len(var_idx), block_variants):
                hi = min(lo + block_variants, len(var_idx))
                blk = _gather_rows(records, var_idx[lo:hi])
                if not keep_all_samples:
                    blk = _subset_block(
                        blk, sam_idx.astype(np.int32), header.num_samples, provider
                    )
                f.write(np.ascontiguousarray(blk).tobytes())

    with timer.stage("write_meta"):
        _write_meta_subset(pvar, var_idx, f"{out_prefix}.pvar")
        _write_meta_subset(psam, sam_idx, f"{out_prefix}.psam")

    return PgenFilterResult(
        out_prefix=out_prefix,
        num_variants_kept=len(var_idx),
        num_samples_kept=n_kept,
        timer=timer,
    )
