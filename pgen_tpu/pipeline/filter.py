"""The flagship filter path: decode -> mask -> gather -> format -> write.

Reference call stack replicated (SURVEY.md §3.1; /root/reference/src/
pfile.rs:104-194 `output_vcf` + main.rs:114-124 dispatch):

  1. parse the 12-byte pgen header
  2. read pvar comments for VCF passthrough
  3. locate the psam IID column (hard error if absent, pfile.rs:125-126)
  4. evaluate --include-var over pvar rows, --include-sam over psam rows
     (vectorized predicate masks instead of per-row evalexpr)
  5. write the VCF header
  6. for each kept variant, emit pvar columns + GT + per-sample tokens

Instead of the reference's per-variant seek/read and per-sample write, the
kept variants stream through in blocks: packed rows are gathered from a
memory map, and each block's text is produced by one of three execution
providers:

  native  — fused C++ LUT emission (one memory pass; default on hosts)
  device  — jax text planes on the GPU (pipeline/device.py checks the
            backend), host assembly of row prefixes
  numpy   — pure-numpy oracle/fallback

Output bytes are identical across providers (tests assert it).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from pgen_tpu.formats.header import read_pgen_header
from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.pipeline.vcf import (
    DEFAULT_SOURCE_TAG,
    emit_rows_numpy,
    vcf_header_bytes,
)
from pgen_tpu.query.compile import compile_predicate
from pgen_tpu.utils.log import get_logger
from pgen_tpu.utils.timer import StageTimer

log = get_logger("filter")

DEFAULT_BLOCK_VARIANTS = 1 << 16

# BGZF end-of-file marker: one empty block (SAM spec §4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _resolve_provider(provider: str) -> str:
    from pgen_tpu.native import HAVE_NATIVE

    if provider == "auto":
        return "native" if HAVE_NATIVE else "numpy"
    if provider == "native" and not HAVE_NATIVE:
        log.warning("native provider unavailable (no C++ toolchain); using numpy")
        return "numpy"
    if provider == "device":
        from pgen_tpu.pipeline.device import device_backend

        device_backend()
    return provider


def _maybe_gt_index_masks(var_node, sam_node, pvar, psam, header, records):
    """Bind GT()/GT_TEXT()/GT_ROW genotype-indexing references in the two
    include-predicates (query/gt_index.py). Variant-axis calls name a
    sample (psam IID); sample-axis calls name a variant (pvar ID)."""
    from pgen_tpu.query.gt_index import bind_gt_index, uses_gt_index

    var_idx_extra = sam_idx_extra = None
    if uses_gt_index((var_node,)):
        if pvar.num_rows > header.num_variants:
            raise ValueError(
                f"{pvar.path} has {pvar.num_rows} rows but the pgen holds "
                f"{header.num_variants} variant records (GT indexing "
                f"requires matching counts)"
            )

        def _iids():
            if "IID" not in psam.columns:
                raise ValueError(f"{psam.path} has no IID column")
            return psam.get_column_bytes("IID")

        (var_node,), var_idx_extra = bind_gt_index(
            (var_node,), records, header.num_samples, pvar, False, _iids
        )
    if uses_gt_index((sam_node,)):
        if psam.num_rows > header.num_samples:
            raise ValueError(
                f"{psam.path} has {psam.num_rows} rows but the pgen holds "
                f"{header.num_samples} samples (GT indexing requires "
                f"matching counts)"
            )

        def _vids():
            if "ID" not in pvar.columns:
                raise ValueError(f"{pvar.path} has no ID column")
            return pvar.get_column_bytes("ID")

        (sam_node,), sam_idx_extra = bind_gt_index(
            (sam_node,), records, header.num_samples, psam, True, _vids
        )
    return var_node, sam_node, var_idx_extra, sam_idx_extra


def compute_masks(var_query, sam_query, pvar, psam, header, records, provider):
    """Evaluate both include-predicates, supporting GT_* genotype-stat
    variables on BOTH axes (an extension over the reference —
    README.md:259-264 lists genotype-valued queries as unsupported there):
    in the variant query they bind per-variant code histograms; in the
    sample query, per-sample ones (GT_MISSING_RATE etc. over ALL variants
    — the plink2 --mind convention: sample QC sees the whole fileset).

    Without GT_* variables the evaluation order matches the reference
    (variants first, pfile.rs:127-128). With them, the sample mask comes
    first so the variant stats are cohort-aware (counts cover kept
    samples only).
    """
    from pgen_tpu.ops.gt_stats import GT_VARIABLE_NAMES, maybe_gt_extra
    from pgen_tpu.query.ast import variables
    from pgen_tpu.query.parser import parse

    from pgen_tpu.query.dup import dup_variables

    var_node = parse(var_query) if isinstance(var_query, str) else var_query
    sam_node = parse(sam_query) if isinstance(sam_query, str) else sam_query
    # GT("IID")/GT_TEXT()/GT_ROW per-sample indexing (query/gt_index.py):
    # rewrite the ASTs up front so every later path sees plain variables
    var_node, sam_node, var_idx_extra, sam_idx_extra = _maybe_gt_index_masks(
        var_node, sam_node, pvar, psam, header, records
    )
    uses_gt = var_node is not None and bool(
        variables(var_node) & set(GT_VARIABLE_NAMES)
    )
    sam_uses_gt = sam_node is not None and bool(
        variables(sam_node) & set(GT_VARIABLE_NAMES)
    )
    # DUP_* whole-column duplicate-group variables (query/dup.py) ride the
    # same extra mechanism as GT_*, computed from the pvar alone
    dup_extra = (
        dup_variables(pvar, variables(var_node))
        if var_node is not None
        else None
    )
    if var_idx_extra:
        dup_extra = {**(dup_extra or {}), **var_idx_extra}
    if not uses_gt and not sam_uses_gt:
        return (
            compile_predicate(var_node, pvar, dup_extra),
            compile_predicate(sam_node, psam, sam_idx_extra),
        )
    if sam_uses_gt:
        from pgen_tpu.ops.gt_stats import gt_variables, sample_counts

        if psam.num_rows > header.num_samples:
            raise ValueError(
                f"{psam.path} has {psam.num_rows} rows but the pgen holds "
                f"{header.num_samples} samples (GT_* stats require "
                f"matching counts)"
            )
        stats_provider = (
            provider if provider in ("native", "device", "numpy") else "native"
        )
        used = variables(sam_node) & set(GT_VARIABLE_NAMES)
        sc = sample_counts(records, header.num_samples, stats_provider)
        sam_extra = gt_variables(sc, header.num_variants, used)
        sam_extra = {k: v[: psam.num_rows] for k, v in sam_extra.items()}
        if sam_idx_extra:
            sam_extra = {**sam_extra, **sam_idx_extra}
        sam_mask = compile_predicate(sam_node, psam, sam_extra)
    else:
        sam_mask = compile_predicate(sam_node, psam, sam_idx_extra)
    if not uses_gt:
        return compile_predicate(var_node, pvar, dup_extra), sam_mask
    sam_idx = np.flatnonzero(sam_mask)
    subset = None if len(sam_idx) == header.num_samples else sam_idx.astype(np.int32)
    stats_provider = provider if provider in ("native", "device", "numpy") else "native"
    extra = maybe_gt_extra(
        var_node, records, header.num_samples, subset, stats_provider
    )
    if extra is not None:
        if pvar.num_rows > header.num_variants:
            raise ValueError(
                f"{pvar.path} has {pvar.num_rows} rows but the pgen holds "
                f"{header.num_variants} variant records (GT_* stats require "
                f"matching counts)"
            )
        extra = {k: v[: pvar.num_rows] for k, v in extra.items()}
    if dup_extra:
        extra = {**(extra or {}), **dup_extra}
    var_mask = compile_predicate(var_node, pvar, extra)
    return var_mask, sam_mask


def duplicated_ids(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    provider: str = "auto",
) -> list:
    """IDs that occur more than once among the variants KEPT by the
    queries (the post-filter set --rm-dup error/list report on,
    matching plink2's filter order)."""
    provider = _resolve_provider(provider)
    header = read_pgen_header(f"{pfile_prefix}.pgen")
    pvar = read_metadata(f"{pfile_prefix}.pvar")
    psam = read_metadata(f"{pfile_prefix}.psam")
    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )
    var_mask, _ = compute_masks(
        var_query, sam_query, pvar, psam, header, records, provider
    )
    ids = pvar.get_column_bytes("ID")[np.flatnonzero(var_mask)]
    uniq, counts = np.unique(ids, return_counts=True)
    return sorted(x.decode() for x in uniq[counts > 1])


@dataclass
class FilterResult:
    out_path: str
    num_variants_kept: int
    num_samples_kept: int
    bytes_written: int
    timer: StageTimer


def _emit_block_meta(
    provider: str,
    packed_block: np.ndarray,
    meta_buf: np.ndarray,
    line_starts: np.ndarray,
    line_ends: np.ndarray,
    sample_idx,
    n_kept_samples: int,
    out_view: np.ndarray,
) -> int:
    """Emit VCF body rows for one block, prefixes taken straight from the
    metadata buffer (zero intermediate copies on the native path)."""
    if provider == "native":
        from pgen_tpu.native import native

        if sample_idx is None:
            return native.emit_vcf_rows_meta(
                packed_block,
                packed_block.shape[1],
                meta_buf,
                line_starts,
                line_ends,
                None,
                n_kept_samples,
                out_view,
            )
        # subsets run the masked-LUT path: kept samples are in file order,
        # so a per-record-byte 4-bit keep mask fully encodes the subset
        rec = packed_block.shape[1]
        byte_masks = np.zeros(rec, dtype=np.uint8)
        np.bitwise_or.at(
            byte_masks,
            sample_idx >> 2,
            np.left_shift(1, sample_idx & 3).astype(np.uint8),
        )
        return native.emit_vcf_rows_masked(
            packed_block,
            rec,
            meta_buf,
            line_starts,
            line_ends,
            byte_masks,
            n_kept_samples,
            out_view,
        )
    # non-native providers: materialize this block's prefixes (vectorized
    # ragged gather, block-sized temporaries), then emit
    pbuf, off = materialize_prefixes(meta_buf, line_starts, line_ends)
    return _emit_block(
        provider, packed_block, pbuf, off, sample_idx, n_kept_samples, out_view
    )


def materialize_prefixes(meta_buf, line_starts, line_ends):
    """Ragged-gather pvar line bytes + "\\tGT" into a dense prefix buffer.

    Returns (pbuf u8, offsets i64 of len n+1): prefix i is
    pbuf[offsets[i]:offsets[i+1]] == meta line bytes + b"\\tGT".
    """
    n = len(line_starts)
    line_lens = line_ends - line_starts
    lens = line_lens + 3
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    pbuf = np.empty(int(off[-1]), dtype=np.uint8)
    if n:
        rows = np.repeat(np.arange(n), line_lens)
        line_pos = np.arange(int(line_lens.sum()), dtype=np.int64)
        starts_cum = np.concatenate(([0], np.cumsum(line_lens)[:-1]))
        within = line_pos - starts_cum[rows]
        pbuf[off[rows] + within] = meta_buf[line_starts[rows] + within]
        gt_idx = off[1:, None] - np.array([3, 2, 1], dtype=np.int64)
        pbuf[gt_idx[:, 0]] = ord("\t")
        pbuf[gt_idx[:, 1]] = ord("G")
        pbuf[gt_idx[:, 2]] = ord("T")
    return pbuf, off


def _emit_block(
    provider: str,
    packed_block: np.ndarray,
    prefix_buf: np.ndarray,
    prefix_off: np.ndarray,
    sample_idx,
    n_kept_samples: int,
    out_view: np.ndarray,
) -> int:
    """Produce VCF body rows for one variant block into out_view."""
    if provider == "native":
        from pgen_tpu.native import native

        return native.emit_vcf_rows_buf(
            packed_block,
            packed_block.shape[1],
            prefix_buf,
            prefix_off,
            sample_idx,
            n_kept_samples,
            out_view,
        )
    if provider == "device":
        import jax.numpy as jnp

        from pgen_tpu.native import HAVE_NATIVE, native
        from pgen_tpu.ops.gt_text import (
            genotype_text_planes,
            subset_text_from_packed,
        )

        dev_packed = jnp.asarray(packed_block)
        if sample_idx is not None:
            # device-side kept-sample gather: d2h ships 4*n_kept B/variant
            # instead of the full 16-B-per-record-byte plane set
            text_host = subset_text_from_packed(dev_packed, sample_idx)
            if HAVE_NATIVE:
                return native.assemble_rows_buf(
                    text_host, prefix_buf, prefix_off, out_view
                )
            return _assemble_rows_numpy(text_host, prefix_buf, prefix_off, out_view)
        # keep-all: plane-form emission (ops/gt_text.planes_from_packed);
        # the host assembler interleaves while copying rows
        planes = [np.asarray(p) for p in genotype_text_planes(dev_packed)]
        gt_len = 4 * n_kept_samples
        if HAVE_NATIVE:
            return native.assemble_rows_planes(
                planes, gt_len, prefix_buf, prefix_off, out_view
            )
        from pgen_tpu.ops.gt_text import interleave_planes_numpy

        text_host = interleave_planes_numpy(planes, gt_len)
        return _assemble_rows_numpy(text_host, prefix_buf, prefix_off, out_view)
    if provider == "numpy":
        return emit_rows_numpy(
            packed_block, prefix_buf, prefix_off, sample_idx, n_kept_samples, out_view
        )
    raise ValueError(f"unknown provider {provider!r}")


@dataclass
class RowLayout:
    """Everything derivable from (fileset, queries): masks, kept indices,
    header bytes, and the deterministic byte layout of every output row.

    Row i's body bytes span
    ``[header_len + prefix_sizes[i] + i*row_fixed, ... i+1 ...)`` — the
    arithmetic every writer (single, sharded, worker-merged) and the index
    emitter must agree on, so it is derived in exactly one place.
    """

    header: object
    pvar: object
    psam: object
    records: np.ndarray
    var_idx: np.ndarray
    sam_idx: np.ndarray
    sample_ids: list
    sample_idx_arg: np.ndarray | None  # None == keep-all fast path
    header_bytes: bytes
    v_starts: np.ndarray
    v_ends: np.ndarray
    prefix_sizes: np.ndarray
    row_fixed: int
    total: int


def derive_row_layout(
    pfile_prefix: str,
    var_query,
    sam_query,
    provider: str,
    source_tag: str = DEFAULT_SOURCE_TAG,
    timer: StageTimer | None = None,
) -> RowLayout:
    """Load the fileset, evaluate both predicates, and pin the output row
    layout (shared by filter_to_vcf, the sharded writers, and the
    merged-.gz indexer)."""
    timer = timer or StageTimer()
    provider = _resolve_provider(provider)
    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
    # IID lookup precedes filtering, so a missing IID column errors even
    # when queries would keep nothing (pfile.rs:111-126 order).
    psam.column_index("IID")

    rec = header.record_size
    pgen_mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    expected = 12 + header.num_variants * rec
    if pgen_mm.shape[0] < expected:
        raise ValueError(
            f"{pfile_prefix}.pgen is {pgen_mm.shape[0]} bytes; header implies {expected}"
        )
    records = pgen_mm[12:expected].reshape(header.num_variants, rec)

    with timer.stage("predicates"):
        var_mask, sam_mask = compute_masks(
            var_query, sam_query, pvar, psam, header, records, provider
        )
    var_idx = np.flatnonzero(var_mask)
    sam_idx = np.flatnonzero(sam_mask)
    all_iids = psam.get_column_strs("IID")
    sample_ids = [all_iids[i] for i in sam_idx]
    n_kept_samples = len(sam_idx)
    # Fast sequential-LUT emission only when the kept set is exactly the
    # pgen's full sample range; otherwise index per sample. (A psam with
    # fewer rows than the pgen is fine — the reference only indexes bytes
    # for rows that exist; more rows than fit a record is an error there
    # too, via the record_buf index panic at pfile.rs:173.)
    keep_all_fast = n_kept_samples == psam.num_rows == header.num_samples
    sample_idx_arg = None if keep_all_fast else sam_idx.astype(np.int32)

    header_bytes = vcf_header_bytes(pvar, sample_ids, source_tag)

    # Row prefixes are raw pvar line bytes + "\tGT"; only their spans are
    # materialized here (emitters read straight from the metadata buffer).
    line_starts_all, line_ends_all = pvar.row_line_spans()
    v_starts = line_starts_all[var_idx]
    v_ends = line_ends_all[var_idx]
    prefix_sizes = np.zeros(len(var_idx) + 1, dtype=np.int64)
    np.cumsum(v_ends - v_starts + 3, out=prefix_sizes[1:])
    row_fixed = 4 * n_kept_samples + 1
    total = len(header_bytes) + int(prefix_sizes[-1]) + len(var_idx) * row_fixed

    if len(var_idx) and var_idx[-1] >= header.num_variants:
        raise ValueError(
            f"{pfile_prefix}.pvar row {int(var_idx[-1])} is beyond the pgen's "
            f"{header.num_variants} variant records"
        )
    if len(sam_idx) and int(sam_idx[-1]) // 4 >= rec:
        raise ValueError(
            f"{pfile_prefix}.psam row {int(sam_idx[-1])} is beyond the pgen's "
            f"{header.num_samples}-sample records"
        )
    return RowLayout(
        header=header,
        pvar=pvar,
        psam=psam,
        records=records,
        var_idx=var_idx,
        sam_idx=sam_idx,
        sample_ids=sample_ids,
        sample_idx_arg=sample_idx_arg,
        header_bytes=header_bytes,
        v_starts=v_starts,
        v_ends=v_ends,
        prefix_sizes=prefix_sizes,
        row_fixed=row_fixed,
        total=total,
    )


def _assemble_rows_numpy(text, prefix_buf, prefix_off, out):
    n_var, gt_len = text.shape
    plens = np.diff(prefix_off)
    row_lens = plens + gt_len + 1
    out_off = np.zeros(n_var + 1, dtype=np.int64)
    np.cumsum(row_lens, out=out_off[1:])
    total = int(out_off[-1])
    if total > out.nbytes:
        raise ValueError("output buffer too small")
    rows = np.repeat(np.arange(n_var), plens)
    src_pos = np.arange(int(prefix_off[-1]), dtype=np.int64)
    out[out_off[rows] + (src_pos - prefix_off[rows])] = prefix_buf
    gstart = out_off[:-1] + plens
    chunk = max(1, (64 << 20) // max(gt_len * 8, 1))
    for lo in range(0, n_var, chunk):
        hi = min(lo + chunk, n_var)
        idx = gstart[lo:hi, None] + np.arange(gt_len, dtype=np.int64)[None, :]
        out[idx] = text[lo:hi]
    out[out_off[1:] - 1] = ord("\n")
    return total


def filter_to_vcf(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | Path | None = None,
    provider: str = "auto",
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
    source_tag: str = DEFAULT_SOURCE_TAG,
    emit_threads: int | None = None,
    index: bool = False,
    index_format: str = "auto",
) -> FilterResult:
    """Filter a pgen fileset to a VCF (reference `filter` subcommand).

    emit_threads: host threads driving native block emission into disjoint
    output ranges (the C ABI releases the GIL). Defaults to min(2, cpus)
    for the native provider, 1 otherwise.
    index: with a .gz output, also emit a tabix index ({out}.tbi, or .csi
    for positions beyond 2^29 / index_format="csi") — every row's
    uncompressed offset is known arithmetically, so indexing never
    re-reads the VCF body (formats/tabix.py).
    """
    provider = _resolve_provider(provider)
    timer = StageTimer()
    if out_file == "-":  # bcftools-style stdout streaming (pipe sink path)
        out_file = "/dev/stdout"
    if out_file is None:
        # default output name parity: main.rs:121-122
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)

    lay = derive_row_layout(
        pfile_prefix, var_query, sam_query, provider, source_tag, timer
    )
    pvar, records = lay.pvar, lay.records
    var_idx, sample_idx_arg = lay.var_idx, lay.sample_idx_arg
    n_kept_samples = len(lay.sam_idx)
    header_bytes, v_starts, v_ends = lay.header_bytes, lay.v_starts, lay.v_ends
    prefix_sizes, row_fixed, total = lay.prefix_sizes, lay.row_fixed, lay.total

    bytes_written = 0
    # .gz output: BGZF-blocked gzip (bcftools/tabix compatible), streamed
    # through the fd path with per-block compression.
    gz = out_file.endswith(".gz")
    if gz:
        from pgen_tpu.native import HAVE_NATIVE

        if not HAVE_NATIVE:
            raise ValueError(
                "bgzf (.gz) output requires the native runtime (C++ toolchain)"
            )
    if index and not gz:
        raise ValueError("--index requires a .gz (BGZF) output file")
    use_mmap = _can_mmap(out_file) and not gz
    if use_mmap:
        # Reuse the existing file's pages when the size matches: truncation
        # would drop the page cache and pay kernel page allocation again.
        if os.path.isfile(out_file) and os.path.getsize(out_file) == total:
            out_mm = np.memmap(out_file, dtype=np.uint8, mode="r+")
        else:
            out_mm = np.memmap(out_file, dtype=np.uint8, mode="w+", shape=(total,))
            if os.environ.get("PGEN_TPU_PRETOUCH") == "1":
                # fresh mapping: overlap the kernel/hypervisor first-touch
                # page backing with emission (cold-output mitigation; on
                # lazy-backing hypervisors the backing rate, not the
                # format work, dominates a cold run)
                _start_pretouch(out_mm)
        out_mm[: len(header_bytes)] = np.frombuffer(header_bytes, dtype=np.uint8)
        # Every block's output offset is known up front (exact size
        # arithmetic), so blocks emit independently — parallel threads
        # write disjoint ranges of the mapped output.
        blocks = []
        pos = len(header_bytes)
        for lo in range(0, len(var_idx), block_variants):
            hi = min(lo + block_variants, len(var_idx))
            cap = int(prefix_sizes[hi] - prefix_sizes[lo]) + (hi - lo) * row_fixed
            blocks.append((lo, hi, pos, cap))
            pos += cap
        assert pos == total, f"size accounting bug: planned {pos}, expected {total}"

        def emit_one(args):
            lo, hi, bpos, cap = args
            packed_blk = _gather_rows(records, var_idx[lo:hi])
            return _emit_block_meta(
                provider,
                packed_blk,
                pvar.data_buffer,
                v_starts[lo:hi],
                v_ends[lo:hi],
                sample_idx_arg,
                n_kept_samples,
                out_mm[bpos : bpos + cap],
            )

        nthreads = emit_threads
        if nthreads is None:
            nthreads = min(2, os.cpu_count() or 1) if provider == "native" else 1
        with timer.stage("emit", nbytes=total - len(header_bytes)):
            if nthreads > 1 and len(blocks) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=nthreads) as ex:
                    ns = list(ex.map(emit_one, blocks))
            else:
                ns = [emit_one(b) for b in blocks]
        for (lo, hi, bpos, cap), n in zip(blocks, ns):
            assert n == cap, f"block [{lo},{hi}) wrote {n}, expected {cap}"
        # no msync: let the OS write back lazily (the reference doesn't
        # fsync either); del just unmaps.
        del out_mm
        bytes_written = total
    else:
        fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:

            def sink(view) -> int:
                if gz:
                    from pgen_tpu.native import native

                    data = (
                        np.frombuffer(view, dtype=np.uint8)
                        if not isinstance(view, np.ndarray)
                        else view
                    )
                    # BGZF members are independent: compress N slices
                    # (each split on a 65280 input-block boundary)
                    # concurrently — the C call releases the GIL, so this
                    # scales to the host's cores on real machines.
                    ncpu = os.cpu_count() or 1
                    nparts = min(ncpu, max(1, data.nbytes // (4 << 20)))
                    if nparts > 1:
                        step = (
                            (data.nbytes + nparts - 1) // nparts + 65279
                        ) // 65280 * 65280
                        slices = [
                            data[o : o + step]
                            for o in range(0, data.nbytes, step)
                        ]
                        from concurrent.futures import ThreadPoolExecutor

                        with ThreadPoolExecutor(len(slices)) as ex:
                            parts = list(ex.map(native.bgzf_compress, slices))
                    else:
                        parts = [native.bgzf_compress(data)]
                    total = 0
                    for p in parts:
                        _write_all(fd, memoryview(p))
                        total += len(p)
                    return total
                _write_all(fd, memoryview(view))
                return len(view)

            bytes_written = sink(memoryview(header_bytes))
            # 1-deep pipeline: block i sinks (compress + write) on a
            # single ordered worker while block i+1 emits; two scratch
            # buffers alternate so emission never overwrites bytes a
            # pending sink still reads. Only pays off when emit and sink
            # get their own cores — on <=2-core hosts the overlap
            # oversubscribes and measures ~1.5x SLOWER (A/B on the dev
            # VM), so it is gated on core count (env override for tests).
            from concurrent.futures import ThreadPoolExecutor

            overlap = (os.cpu_count() or 1) >= 4 or os.environ.get(
                "PGEN_TPU_SINK_PIPELINE"
            ) == "1"
            scratches = [None, None]
            pending = None
            with ThreadPoolExecutor(1) as sink_worker:
                for bi, lo in enumerate(range(0, len(var_idx), block_variants)):
                    hi = min(lo + block_variants, len(var_idx))
                    idx_blk = var_idx[lo:hi]
                    packed_blk = _gather_rows(records, idx_blk)
                    cap = (
                        int(prefix_sizes[hi] - prefix_sizes[lo])
                        + (hi - lo) * row_fixed
                    )
                    which = (bi & 1) if overlap else 0
                    if scratches[which] is None or scratches[which].nbytes < cap:
                        scratches[which] = np.empty(cap, dtype=np.uint8)
                    scratch = scratches[which]
                    with timer.stage("emit") as st:
                        n = _emit_block_meta(
                            provider,
                            packed_blk,
                            pvar.data_buffer,
                            v_starts[lo:hi],
                            v_ends[lo:hi],
                            sample_idx_arg,
                            n_kept_samples,
                            scratch,
                        )
                        st.bytes_moved += n
                    if pending is not None:
                        bytes_written += pending.result()
                        pending = None
                    if overlap:
                        pending = sink_worker.submit(sink, scratch[:n])
                    else:
                        bytes_written += sink(scratch[:n])
                if pending is not None:
                    bytes_written += pending.result()
            if gz:
                _write_all(fd, memoryview(BGZF_EOF))
                bytes_written += len(BGZF_EOF)
        finally:
            os.close(fd)

    if index:
        with timer.stage("index"):
            emit_tabix_index(
                out_file,
                pvar,
                var_idx,
                prefix_sizes,
                row_fixed,
                len(header_bytes),
                fmt=index_format,
            )

    log.info("filter: %s", timer.report())
    return FilterResult(
        out_path=out_file,
        num_variants_kept=len(var_idx),
        num_samples_kept=n_kept_samples,
        bytes_written=bytes_written,
        timer=timer,
    )


def emit_tabix_index(
    gz_path: str,
    pvar,
    var_idx: np.ndarray,
    prefix_sizes: np.ndarray,
    row_fixed: int,
    header_len: int,
    fmt: str = "auto",
) -> str:
    """Emit {gz_path}.tbi (or .csi) for the rows just written (kept order
    var_idx). fmt: tbi/csi/auto — auto picks .csi when any position
    exceeds the .tbi 2^29 ceiling.

    Row i's uncompressed byte span is pure arithmetic:
    [header_len + prefix_sizes[i] + i*row_fixed, ... i+1 ...).
    """
    from pgen_tpu.formats.tabix import build_index_for_vcf_gz

    for col in ("CHROM", "POS", "REF"):
        if col not in pvar.columns:
            raise ValueError(f"--index requires a {col} column in the .pvar")
    chroms = pvar.get_column_bytes("CHROM")[var_idx]
    try:
        pos = pvar.get_column_bytes("POS")[var_idx].astype(np.int64)
    except (ValueError, OverflowError) as e:
        raise ValueError(f"--index requires integer POS values: {e}") from None
    _, ref_lens_all = pvar.get_column_padded("REF")
    ref_lens = np.asarray(ref_lens_all, dtype=np.int64)[var_idx]
    n = len(var_idx)
    idx = np.arange(n, dtype=np.int64)
    u_starts = header_len + prefix_sizes[:-1] + idx * row_fixed
    u_ends = header_len + prefix_sizes[1:] + (idx + 1) * row_fixed
    return build_index_for_vcf_gz(
        gz_path, chroms, pos, ref_lens, u_starts, u_ends, fmt=fmt
    )


def _write_all(fd: int, view: memoryview) -> None:
    """os.write until the whole view is on the fd. A single os.write may
    return short on a pipe (e.g. interrupted after a partial transfer);
    silently dropping the remainder would truncate the VCF."""
    view = view.cast("B")
    while len(view):
        n = os.write(fd, view)
        view = view[n:]


def _pwrite_all(fd: int, data, offset: int) -> None:
    """os.pwrite until everything lands at offset. A single pwrite caps at
    ~2 GiB on Linux (and may return short on EINTR); dropping the
    remainder would leave stale bytes mid-file with no error."""
    view = memoryview(data).cast("B")
    while len(view):
        n = os.pwrite(fd, view, offset)
        view = view[n:]
        offset += n


def _gather_rows(records: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row gather that stays zero-copy for contiguous kept ranges (the
    keep-all fast path reads straight from the .pgen memory map)."""
    if len(idx) and int(idx[-1]) - int(idx[0]) + 1 == len(idx):
        return records[int(idx[0]) : int(idx[-1]) + 1]
    return records[idx]


def _start_pretouch(out_mm: np.memmap) -> None:
    """Kick off asynchronous page backing for a FRESH output mapping.

    madvise(MADV_WILLNEED) asks the kernel to populate the (hole) pages
    in the background, and a daemon READER thread walks one byte per
    page front-to-back — reads allocate the page-cache page (the
    expensive hypervisor-backed step) without racing the emit threads'
    writes, which then only take the cheap write-protect fault. Gated by
    PGEN_TPU_PRETOUCH=1; a measured experiment, not a default (on a
    2-core box the toucher competes with the emitters for CPU)."""
    import mmap as _mmap
    import threading

    try:
        out_mm._mmap.madvise(_mmap.MADV_WILLNEED)
    except (AttributeError, OSError):
        pass

    def _touch(view=out_mm, step=4096):
        sink = 0
        try:
            for off in range(0, len(view), step):
                sink += int(view[off])
        except (ValueError, SystemError):
            pass  # mapping closed mid-walk: emission already finished
        return sink

    threading.Thread(target=_touch, daemon=True).start()


def _can_mmap(path: str) -> bool:
    """mmap emission needs a regular (seekable) output file."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        # new file in a writable directory: fine
        parent = os.path.dirname(path) or "."
        return os.path.isdir(parent)
    import stat as stat_mod

    return stat_mod.S_ISREG(st.st_mode)
