"""`pgen-tpu king`: pairwise KING-robust kinship table.

The plink2 `--make-king-table` analog (an extension — the reference's
scope stops at query/filter, /root/reference/README.md:3-5). Accepts the
same include/exclude predicates, regions, and sample lists as `filter`,
computes the four pair-count Gram matrices on the chosen provider
(ops/king.py — the GPU matmul path), and emits a `.kin0`-flavored TSV:

    #IID1  IID2  NSNP  HETHET  IBS0  KINSHIP

one row per unordered sample pair (i < j, psam order), where NSNP is the
both-called variant count, HETHET and IBS0 are proportions of NSNP, and
KINSHIP is the robust estimator. `--min-kinship X` keeps only rows with
KINSHIP >= X (the plink2 `--king-table-filter` analog); pairs with an
undefined estimate (zero denominator) print `nan` and are dropped by any
--min-kinship threshold.

`--cutoff X` switches to the plink2 `--king-cutoff` analog: instead of a
table, greedily drop samples until no surviving pair has kinship > X —
each round removes the sample participating in the most above-cutoff
surviving pairs (tie: the later psam index; NaN pairs never count) — and
write {out}.king.cutoff.in.id / {out}.king.cutoff.out.id (one IID per
line, psam order).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from pgen_tpu.formats.header import read_pgen_header
from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.pipeline.filter import _gather_rows, _resolve_provider, compute_masks
from pgen_tpu.utils.timer import StageTimer

# beyond this many variants, device calls are chunked so each call's f32
# Gram accumulation stays exact (ops/king.py); chunks sum in f64 on host
_DEVICE_EXACT_VARIANTS = 1 << 23


@dataclass
class KingResult:
    num_variants: int
    num_samples: int
    num_pairs: int
    out_path: str | None
    kinship: np.ndarray
    ibs0: np.ndarray
    nsnp: np.ndarray
    timer: StageTimer = field(default_factory=StageTimer)


def king_counts_chunked(records, num_samples, provider, sample_idx, timer,
                        block_variants=None):
    """Provider dispatch with host-side f64 accumulation across chunks.

    Each chunk is small enough that the device provider's f32 Grams are
    exact; the f64 sums keep exactness for any total variant count.
    """
    from pgen_tpu.ops.king import KingCounts, king_counts

    kw = {}
    if block_variants:
        kw["block_variants"] = int(block_variants)
    nvar = records.shape[0]
    step = _DEVICE_EXACT_VARIANTS if provider == "device" else nvar or 1
    total = None
    nbytes = records.shape[0] * records.shape[1]
    with timer.stage("king_grams", nbytes):
        for lo in range(0, max(nvar, 1), max(step, 1)):
            part = king_counts(
                records[lo : lo + step],
                num_samples,
                provider=provider,
                sample_idx=sample_idx,
                **kw,
            )
            total = part if total is None else KingCounts(
                *(a + b for a, b in zip(total, part))
            )
        if total is None:
            ns = num_samples if sample_idx is None else len(sample_idx)
            z = np.zeros((ns, ns), dtype=np.float64)
            total = KingCounts(z, z.copy(), z.copy(), z.copy())
    return total


def king_cutoff_mask(kin: np.ndarray, cutoff: float) -> np.ndarray:
    """Greedy relatedness pruning: bool keep-mask over the cohort.

    While any surviving pair exceeds the cutoff, remove the sample with
    the most above-cutoff surviving pairs (tie: the later index). NaN
    kinships (undefined estimates) never count as above-cutoff.
    """
    over = np.nan_to_num(kin, nan=-np.inf) > cutoff
    np.fill_diagonal(over, False)
    keep = np.ones(kin.shape[0], dtype=bool)
    while True:
        deg = (over & keep[None, :] & keep[:, None]).sum(axis=1)
        deg[~keep] = 0
        worst = int(deg.max()) if len(deg) else 0
        if worst == 0:
            return keep
        # ties resolve to the LATER index: argmax on the reversed array
        victim = len(deg) - 1 - int(np.argmax(deg[::-1]))
        keep[victim] = False


def king_table(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    min_kinship: float | None = None,
    block_variants: int | None = None,
    out=None,
    cutoff: float | None = None,
) -> KingResult:
    provider = _resolve_provider(provider)
    if provider == "native":
        provider = "numpy"  # BLAS is the host matmul engine (ops/king.py)
    timer = StageTimer()

    header = read_pgen_header(f"{pfile_prefix}.pgen")
    pvar = read_metadata(f"{pfile_prefix}.pvar")
    psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")

    rec = header.record_size
    mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    records = mm[12 : 12 + header.num_variants * rec].reshape(
        header.num_variants, rec
    )
    with timer.stage("predicates"):
        var_mask, sam_mask = compute_masks(
            var_query, sam_query, pvar, psam, header, records, provider
        )
        var_idx = np.flatnonzero(var_mask)
        sam_idx = np.flatnonzero(sam_mask)
    if len(sam_idx) < 2:
        raise ValueError(
            f"king needs >= 2 samples after filtering (got {len(sam_idx)})"
        )
    with timer.stage("gather", len(var_idx) * rec):
        kept = _gather_rows(records, var_idx)

    subset = (
        None if len(sam_idx) == header.num_samples
        else sam_idx.astype(np.int32)
    )
    counts = king_counts_chunked(
        kept, header.num_samples, provider, subset, timer, block_variants
    )

    from pgen_tpu.ops.king import king_kinship

    kin, ibs0 = king_kinship(counts)
    iids = psam.get_column_strs("IID")
    iids = [iids[int(s)] for s in sam_idx]

    if cutoff is not None:
        keep = king_cutoff_mask(kin, cutoff)
        out_path = out_file or pfile_prefix
        with timer.stage("king_emit"):
            with open(f"{out_path}.king.cutoff.in.id", "w") as fh:
                fh.writelines(
                    f"{iid}\n" for iid, k in zip(iids, keep) if k
                )
            with open(f"{out_path}.king.cutoff.out.id", "w") as fh:
                fh.writelines(
                    f"{iid}\n" for iid, k in zip(iids, keep) if not k
                )
        return KingResult(
            num_variants=len(var_idx),
            num_samples=len(sam_idx),
            num_pairs=int(keep.sum()),  # kept samples in cutoff mode
            out_path=out_path,
            kinship=kin,
            ibs0=ibs0,
            nsnp=counts.nsnp,
            timer=timer,
        )

    n_pairs = 0
    if out is not None:
        n_pairs = _emit_rows(out, iids, kin, ibs0, counts, min_kinship, timer)
        out_path = None
    else:
        out_path = out_file or f"{pfile_prefix}.kin0"
        with open(out_path, "w") as fh:
            n_pairs = _emit_rows(fh, iids, kin, ibs0, counts, min_kinship, timer)
    return KingResult(
        num_variants=len(var_idx),
        num_samples=len(sam_idx),
        num_pairs=n_pairs,
        out_path=out_path,
        kinship=kin,
        ibs0=ibs0,
        nsnp=counts.nsnp,
        timer=timer,
    )


def _emit_rows(out, iids, kin, ibs0, counts, min_kinship, timer) -> int:
    """#IID1 IID2 NSNP HETHET IBS0 KINSHIP rows (i < j, psam order)."""
    ns = len(iids)
    ii, jj = np.triu_indices(ns, k=1)
    k = kin[ii, jj]
    if min_kinship is not None:
        keep = k >= min_kinship  # NaN compares false -> dropped
        ii, jj, k = ii[keep], jj[keep], k[keep]
    n = counts.nsnp[ii, jj]
    safe_n = np.maximum(n, 1)
    hethet = np.where(n > 0, counts.hethet[ii, jj] / safe_n, 0.0)
    ib = np.where(n > 0, ibs0[ii, jj] / safe_n, 0.0)
    with timer.stage("king_emit"):
        out.write("#IID1\tIID2\tNSNP\tHETHET\tIBS0\tKINSHIP\n")
        write = out.write
        for a, b, nn, hh, i0, kk in zip(ii, jj, n, hethet, ib, k):
            write(
                f"{iids[a]}\t{iids[b]}\t{int(nn)}\t"
                f"{hh:.6g}\t{i0:.6g}\t{kk:.6g}\n"
            )
    return len(ii)
