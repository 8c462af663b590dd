"""`pgen-tpu ld`: pairwise LD r² table (plink --r2 analog).

An extension — the reference's scope stops at query/filter
(/root/reference/README.md:3-5). Reuses the banded-r² Gram machinery
that backs prune/clump (ops/ld.py: one gemm per band tile, matmul-shaped
on the device provider) and emits plink 1.9's .ld layout:

    CHR_A BP_A SNP_A CHR_B BP_B SNP_B R2

one row per reported pair, A before B in fileset order. Windowing pins
plink's three knobs (documented conventions):

  * --ld-window N      index distance: j - i < N         (default 10)
  * --ld-window-kb X   |POS_j - POS_i| <= X * 1000       (default 1000)
  * --ld-window-r2 T   r² >= T                           (default 0.2)

r² uses mean-imputed centered dosages (missing at the mean — see
ops/ld.py); pairs never span a chromosome-run boundary. Variants must
be grouped by chromosome (run `sort` first if unsure).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from pgen_tpu.formats.header import read_pgen_header
from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.pipeline.filter import _gather_rows, _resolve_provider, compute_masks
from pgen_tpu.utils.timer import StageTimer


@dataclass
class LdResult:
    num_variants: int
    num_samples: int
    num_pairs: int
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def _chrom_runs(chroms: list):
    runs = []
    lo = 0
    for i in range(1, len(chroms) + 1):
        if i == len(chroms) or chroms[i] != chroms[lo]:
            runs.append((lo, i))
            lo = i
    return runs


def ld_report(
    pfile_prefix: str,
    out_file: str | None = None,
    var_query: str | None = None,
    sam_query: str | None = None,
    provider: str = "auto",
    ld_window: int = 10,
    ld_window_kb: float = 1000.0,
    ld_window_r2: float = 0.2,
    out=None,
) -> LdResult:
    if ld_window < 2:
        raise ValueError("--ld-window must be >= 2 (at least one pair)")
    provider = _resolve_provider(provider)
    if provider == "native":
        provider = "numpy"  # BLAS is the host gemm engine (ops/ld.py)
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
    with timer.stage("gather", len(var_idx) * rec):
        kept = _gather_rows(records, var_idx)

    all_chroms = pvar.get_column_strs("CHROM")
    all_pos = pvar.get_column_strs("POS")
    all_ids = pvar.get_column_strs("ID")
    chroms = [all_chroms[int(v)] for v in var_idx]
    try:
        pos = np.array([int(all_pos[int(v)]) for v in var_idx], dtype=np.int64)
    except ValueError as e:
        raise ValueError(f"ld: non-integer POS in {pvar.path}: {e}") from None
    ids = [all_ids[int(v)] for v in var_idx]

    from pgen_tpu.ops.ld import banded_r2

    band = ld_window - 1
    subset = (
        None if len(sam_idx) == header.num_samples
        else sam_idx.astype(np.int32)
    )
    n_pairs = 0

    def emit(fh):
        nonlocal n_pairs
        fh.write("#CHR_A\tBP_A\tSNP_A\tCHR_B\tBP_B\tSNP_B\tR2\n")
        max_bp = ld_window_kb * 1000.0
        for lo, hi in _chrom_runs(chroms):
            w = hi - lo
            if w < 2:
                continue
            with timer.stage("r2_band", w * rec):
                r2 = banded_r2(
                    kept[lo:hi], header.num_samples, min(band, w - 1),
                    provider=provider, sample_idx=subset,
                )
            cpos = pos[lo:hi]
            chrom = chroms[lo]
            with timer.stage("ld_emit"):
                # pos distance per (i, d): pos[i+1+d] - pos[i], edge-padded
                bw = r2.shape[1]
                dist = np.full((w, bw), np.inf)
                for d in range(bw):
                    n = w - 1 - d
                    if n > 0:
                        # |POS_j - POS_i|: POS is not validated as sorted,
                        # so a signed difference would let any out-of-order
                        # pair (negative distance) bypass the kb window
                        dist[:n, d] = np.abs(cpos[1 + d :] - cpos[:n])
                keep = (r2 >= ld_window_r2) & (dist <= max_bp)
                for i, d in zip(*np.nonzero(keep)):
                    j = i + 1 + d
                    fh.write(
                        f"{chrom}\t{cpos[i]}\t{ids[lo + i]}\t{chrom}\t"
                        f"{cpos[j]}\t{ids[lo + j]}\t{r2[i, d]:.6g}\n"
                    )
                n_pairs += int(keep.sum())

    with timer.stage("total_emit"):
        if out is not None:
            emit(out)
            out_path = None
        else:
            out_path = out_file or f"{pfile_prefix}.ld"
            with open(out_path, "w") as fh:
                emit(fh)
    return LdResult(
        num_variants=len(var_idx),
        num_samples=len(sam_idx),
        num_pairs=n_pairs,
        out_path=out_path,
        timer=timer,
    )
