"""`pgen-tpu score`: polygenic scores from a per-variant weight table.

plink2 `--score` analog (extension over the reference, which is a
query/filter tool — /root/reference/README.md:3-5). A scoring file gives,
per line: a variant ID, the effect allele, and one or more numeric effect
weights. Variants are matched to the fileset by the pvar ID column; the
effect allele must equal REF or ALT (REF matches run "flipped": dosage =
2 - alt count). The per-sample score sums are blocked matmuls on the
chosen provider (ops/score.py: GPU matmuls on device, BLAS on host).

Score-file shape (whitespace- or tab-separated):
  - column `var_id_col` (1-based, default 1): variant ID
  - column `allele_col` (default 2): effect allele string
  - columns `weight_cols` (default [3]): one score per listed column
  - a header line is auto-detected (first weight cell not parseable as a
    float) and, when present, names the score columns in the output.

Output `{out}.sscore` (TSV), one row per kept sample:
    #IID  ALLELE_CT  DOSAGE_SUM  <NAME>_AVG ...  [<NAME>_SUM ... with sums]
where <NAME>_AVG = score sum / ALLELE_CT (0 when the denominator is 0).
ALLELE_CT follows plink2: 2 x the number of scored variants contributing
to that sample (all scoreable variants under mean imputation, the
sample's called ones with --no-mean-imputation); zero-called variants
never count.

Unmatched score lines and allele mismatches are skipped with one stderr
warning each (counts included); a duplicate variant ID in the score file
is an error.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pgen_tpu.formats.header import read_pgen_header
from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.pipeline.filter import _gather_rows, _resolve_provider, compute_masks
from pgen_tpu.utils.log import get_logger
from pgen_tpu.utils.timer import StageTimer

log = get_logger(__name__)


@dataclass
class ScoreTable:
    """Parsed scoring file: aligned ID/allele/weight rows."""

    ids: list
    alleles: list
    weights: np.ndarray  # (M, K) f64
    names: list  # K score names


@dataclass
class ScoreRunResult:
    num_scored: int  # variants entering the matmul
    num_unmatched: int  # score lines with no pvar ID match
    num_mismatched: int  # matched but effect allele is neither REF nor ALT
    num_samples: int
    names: list
    sums: np.ndarray  # (S, K)
    avgs: np.ndarray  # (S, K)
    allele_ct: np.ndarray  # (S,)
    dosage_sum: np.ndarray  # (S,)
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def parse_col_nums(spec: str) -> tuple:
    """plink2-style 1-based column list: '3-5,7' -> (3, 4, 5, 7)."""
    out = []
    for raw in str(spec).split(","):
        tok = raw.strip()
        if not tok:
            continue
        lo, dash, hi = tok.partition("-")
        try:
            if dash:
                a, b = int(lo), int(hi)
                if b < a:
                    raise ValueError
                out.extend(range(a, b + 1))
            else:
                out.append(int(tok))
        except ValueError:
            raise ValueError(
                f"score: bad column list {spec!r} (want e.g. '3-5,7')"
            ) from None
    if not out:
        raise ValueError(f"score: empty column list {spec!r}")
    return tuple(out)


def _parse_float(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def read_score_file(
    path: str,
    var_id_col: int = 1,
    allele_col: int = 2,
    weight_cols=(3,),
    header_row: str = "auto",
) -> ScoreTable:
    """Parse the scoring table; 1-based column indices, plink2-style.
    `header_row` is "auto" (heuristic below), "yes", or "no"."""
    if header_row not in ("auto", "yes", "no"):
        raise ValueError(f"score: header_row must be auto/yes/no, "
                         f"got {header_row!r}")
    cols = [var_id_col, allele_col, *weight_cols]
    if min(cols) < 1:
        raise ValueError("score: column numbers are 1-based")
    if len(set(cols)) != len(cols):
        raise ValueError("score: ID/allele/weight columns must be distinct")
    ids, alleles, rows = [], [], []
    names = [f"SCORE{i + 1}" for i in range(len(weight_cols))]
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if not lines:
        raise ValueError(f"score: {path} is empty")
    need = max(cols)
    first = lines[0].split()
    if len(first) < need:
        raise ValueError(
            f"score: {path} line 1 has {len(first)} fields, need {need}"
        )
    start = 0
    # Header heuristic: line 1 is a header only if EVERY weight cell
    # fails to parse as a number, none of them is a missing-value token
    # (a headerless file whose first weight is 'NA' is data with a bad
    # cell, reported below — not a header to drop silently), and the ID
    # cell is non-numeric too (guards numeric column names like '2019'
    # from swallowing a data row).
    missing_tokens = {"NA", "na", "N/A", ".", ""}
    w_first = [first[c - 1] for c in weight_cols]
    is_header = (
        all(_parse_float(w) is None for w in w_first)
        and not any(w in missing_tokens for w in w_first)
        and _parse_float(first[var_id_col - 1]) is None
    ) if header_row == "auto" else (header_row == "yes")
    if is_header:
        names = [first[c - 1] for c in weight_cols]
        start = 1
    for lineno, ln in enumerate(lines[start:], start + 1):
        f = ln.split()
        if len(f) < need:
            raise ValueError(
                f"score: {path} line {lineno} has {len(f)} fields, need {need}"
            )
        w = []
        for c in weight_cols:
            v = _parse_float(f[c - 1])
            if v is None:
                hint = (
                    " (line 1 is treated as data because its ID/weight "
                    "cells look numeric or missing-valued; pass "
                    "--header-row to force a header)"
                    if lineno == 1 else ""
                )
                raise ValueError(
                    f"score: {path} line {lineno} col {c}: "
                    f"{f[c - 1]!r} is not a number{hint}"
                )
            w.append(v)
        ids.append(f[var_id_col - 1])
        alleles.append(f[allele_col - 1])
        rows.append(w)
    if not ids:
        raise ValueError(f"score: {path} has no data rows")
    weights = np.asarray(rows, dtype=np.float64)
    dup = len(ids) - len(set(ids))
    if dup:
        raise ValueError(f"score: {path} has {dup} duplicate variant ID(s)")
    return ScoreTable(ids, alleles, weights, names)


def read_q_ranges(path: str) -> list:
    """plink --q-score-range range file: NAME MIN MAX per line
    (whitespace-separated; blank/# lines skipped)."""
    ranges = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) != 3:
                raise ValueError(
                    f"--q-score-range: bad range line {ln!r} "
                    "(need NAME MIN MAX)"
                )
            try:
                ranges.append((parts[0], float(parts[1]), float(parts[2])))
            except ValueError:
                raise ValueError(
                    f"--q-score-range: non-numeric bound in {ln!r}"
                ) from None
    if not ranges:
        raise ValueError(f"--q-score-range: {path} has no ranges")
    return ranges


def read_q_data(path: str, data_col: int = 2) -> dict:
    """plink --q-score-range data file: variant ID (col 1) -> value
    (1-based data_col, default 2). A first line whose value cell does
    not parse is treated as a header. First occurrence wins."""
    vals: dict = {}
    with open(path) as fh:
        for ln_no, ln in enumerate(fh):
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) < data_col:
                continue
            try:
                v = float(parts[data_col - 1])
            except ValueError:
                if ln_no == 0:
                    continue  # header line
                continue  # NA-style value: variant lands in no range
            vals.setdefault(parts[0], v)
    if not vals:
        raise ValueError(f"--q-score-range: {path} has no data rows")
    return vals


def score_pfile(
    pfile_prefix: str,
    score_file: str,
    var_id_col: int = 1,
    allele_col: int = 2,
    weight_cols=(3,),
    header_row: str = "auto",
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    mean_impute: bool = True,
    write_sums: bool = False,
    block_variants: int | None = None,
    write: bool = True,
    out=None,
    q_score_range=None,
    q_data_col: int = 2,
    center: bool = False,
    variance_standardize: bool = False,
) -> ScoreRunResult:
    """q_score_range (plink --q-score-range analog): a (range_file,
    data_file) pair. Matched score variants are partitioned by the data
    file's value (typically an association P) into each range's
    [MIN, MAX] (inclusive); one {out_base}.{NAME}.sscore is written per
    range (ranges with zero matched variants are skipped with a
    warning, like plink). The base .sscore is NOT written; the returned
    arrays are the LAST written range's, out_path lists every file.
    With a stream (``out``, e.g. `-o -`), the per-range tables are
    streamed to it as ONE table with a leading RANGE column instead of
    per-range files."""
    provider = _resolve_provider(provider)
    # "native" reaches ops/score.py's sparse-complement C++ kernel
    # (numpy/BLAS fallback when the toolchain is absent)
    timer = StageTimer()

    with timer.stage("score_file"):
        table = read_score_file(score_file, var_id_col, allele_col,
                                weight_cols, header_row)

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
        sam_idx = np.flatnonzero(sam_mask)
    n_sam = len(sam_idx)
    if n_sam == 0:
        raise ValueError("score: no samples left after filtering")

    with timer.stage("match"):
        pvar_ids = pvar.get_column_strs("ID")
        refs = pvar.get_column_strs("REF")
        alts = pvar.get_column_strs("ALT")
        id_to_row: dict = {}
        for row, vid in enumerate(pvar_ids):
            id_to_row.setdefault(vid, row)  # first occurrence wins
        var_rows, w_rows, flips = [], [], []
        unmatched = mismatched = 0
        for i, (vid, a1) in enumerate(zip(table.ids, table.alleles)):
            row = id_to_row.get(vid)
            if row is None or not var_mask[row]:
                unmatched += 1
                continue
            if a1 == alts[row]:
                flips.append(False)
            elif a1 == refs[row]:
                flips.append(True)
            else:
                mismatched += 1
                continue
            var_rows.append(row)
            w_rows.append(i)
        order = np.argsort(np.asarray(var_rows, dtype=np.int64), kind="stable")
        var_idx = np.asarray(var_rows, dtype=np.int64)[order]
        weights = table.weights[np.asarray(w_rows, dtype=np.int64)[order]]
        flip = np.asarray(flips, dtype=bool)[order]
    if unmatched:
        log.warning(
            "score: %d score line(s) had no matching kept variant", unmatched
        )
    if mismatched:
        log.warning(
            "score: %d score line(s) skipped (effect allele matches "
            "neither REF nor ALT)", mismatched,
        )
    if len(var_idx) == 0:
        raise ValueError("score: no score variants matched the fileset")

    with timer.stage("gather", len(var_idx) * rec):
        kept = _gather_rows(records, var_idx)

    from pgen_tpu.ops.score import score

    subset = None if n_sam == header.num_samples else sam_idx.astype(np.int32)
    kw = {"block_variants": int(block_variants)} if block_variants else {}

    # plink2 `center` / `variance-standardize` modifiers. Under mean
    # imputation both reduce to a weight rescale plus a per-score
    # constant offset — no provider changes:
    #   sum_v (d - mu)/sd * w = sum_v d * (w/sd) - sum_v mu * (w/sd)
    # (imputed-missing dosages equal mu, so their transformed value is 0,
    # exactly the centered semantics). Without imputation a missing call
    # contributes raw 0, which the offset trick would wrongly shift to
    # -mu/sd, so the combination is rejected.
    score_offset = None
    mu_eff_w = None
    if center or variance_standardize:
        if not mean_impute:
            raise ValueError(
                "score: center/variance-standardize require mean "
                "imputation (drop --no-mean-imputation)"
            )
        from pgen_tpu.ops.gt_stats import gt_counts, gt_counts_subset

        with timer.stage("moments", kept.shape[0] * rec):
            cts = (
                gt_counts_subset(kept, subset)
                if subset is not None
                else gt_counts(kept, header.num_samples)
            )
        n_called = cts[:, :3].sum(axis=1).astype(np.float64)
        used = n_called > 0
        safe_n = np.maximum(n_called, 1.0)
        mu_alt = (cts[:, 1] + 2.0 * cts[:, 2]) / safe_n
        if variance_standardize:
            ex2 = (cts[:, 1] + 4.0 * cts[:, 2]) / safe_n
            var = ex2 - mu_alt * mu_alt
            bad = used & (var <= 0)
            if bad.any():
                raise ValueError(
                    f"score: --variance-standardize: {int(bad.sum())} "
                    "matched variant(s) have zero dosage variance over "
                    "the cohort (drop them, e.g. GT_MAF > 0)"
                )
            weights = weights / np.sqrt(np.where(used, var, 1.0))[:, None]
        mu_eff = np.where(flip, 2.0 - mu_alt, mu_alt) * used
        mu_eff_w = mu_eff  # per-variant effect-allele means (offsets)
        score_offset = mu_eff @ weights  # (K,)

    if q_score_range is not None:
        ranges = read_q_ranges(q_score_range[0])
        vals = read_q_data(q_score_range[1], q_data_col)
        matched_ids = [pvar_ids[int(r)] for r in var_idx]
        v = np.array([vals.get(i, np.nan) for i in matched_ids])
        base = out_file or pfile_prefix
        if base.endswith(".sscore"):
            base = base[: -len(".sscore")]
        iids_q = psam.get_column_strs("IID")
        iids_q = [iids_q[int(s)] for s in sam_idx]
        hdr = ["#IID", "ALLELE_CT", "DOSAGE_SUM"]
        hdr += [f"{n}_AVG" for n in table.names]
        if write_sums:
            hdr += [f"{n}_SUM" for n in table.names]
        if out is not None:  # streaming: one table, leading RANGE column
            out.write("\t".join(["#RANGE"] + [h.lstrip("#") for h in hdr])
                      + "\n")
        out_paths = []
        last = None
        with np.errstate(invalid="ignore"):
            sels = [
                np.flatnonzero(~np.isnan(v) & (v >= rlo) & (v <= rhi))
                for _, rlo, rhi in ranges
            ]
        for (name, _, _), sel in zip(ranges, sels):
            if sel.size == 0:
                log.warning(
                    "score: --q-score-range %s matched no variants", name
                )
                continue
            with timer.stage("score", len(sel) * rec):
                rres = score(
                    kept[sel], header.num_samples, weights[sel], flip[sel],
                    provider=provider, mean_impute=mean_impute,
                    sample_idx=subset, **kw,
                )
            if mu_eff_w is not None:
                rres = rres._replace(
                    sums=rres.sums - (mu_eff_w[sel] @ weights[sel])[None, :]
                )
            rct = rres.allele_ct
            ravgs = rres.sums / np.maximum(rct, 1)[:, None]
            def _rows(fh, lead=()):
                for r, iid in enumerate(iids_q):
                    cells = [*lead, iid, str(int(rct[r])),
                             f"{rres.dosage_sum[r]:.10g}"]
                    cells += [
                        f"{ravgs[r, c]:.10g}"
                        for c in range(ravgs.shape[1])
                    ]
                    if write_sums:
                        cells += [
                            f"{rres.sums[r, c]:.10g}"
                            for c in range(rres.sums.shape[1])
                        ]
                    fh.write("\t".join(cells) + "\n")

            if out is not None:
                path = f"<stream>.{name}"
                with timer.stage("emit"):
                    _rows(out, lead=(name,))
            else:
                path = f"{base}.{name}.sscore"
                if write:
                    with timer.stage("emit"), open(path, "w") as fh:
                        fh.write("\t".join(hdr) + "\n")
                        _rows(fh)
            out_paths.append(path)
            last = (rres, rct, ravgs, int(sel.size))
        if last is None:
            raise ValueError(
                "score: no --q-score-range range matched any variant"
            )
        rres, rct, ravgs, n_last = last
        return ScoreRunResult(
            num_scored=n_last,
            num_unmatched=unmatched,
            num_mismatched=mismatched,
            num_samples=n_sam,
            names=list(table.names),
            sums=rres.sums,
            avgs=ravgs,
            allele_ct=rct,
            dosage_sum=rres.dosage_sum,
            out_path="; ".join(out_paths),
            timer=timer,
        )

    with timer.stage("score", kept.shape[0] * rec):
        res = score(
            kept, header.num_samples, weights, flip, provider=provider,
            mean_impute=mean_impute, sample_idx=subset, **kw,
        )
    if score_offset is not None:
        res = res._replace(sums=res.sums - score_offset[None, :])
    ct = res.allele_ct
    avgs = res.sums / np.maximum(ct, 1)[:, None]

    out_path = out_file or f"{pfile_prefix}.sscore"
    iids = psam.get_column_strs("IID")
    iids = [iids[int(s)] for s in sam_idx]
    if write:
        hdr = ["#IID", "ALLELE_CT", "DOSAGE_SUM"]
        hdr += [f"{n}_AVG" for n in table.names]
        if write_sums:
            hdr += [f"{n}_SUM" for n in table.names]
        with timer.stage("emit"):
            import contextlib

            cm = (
                contextlib.nullcontext(out)
                if out is not None
                else open(out_path, "w")
            )
            with cm as fh:
                fh.write("\t".join(hdr) + "\n")
                for r, iid in enumerate(iids):
                    cells = [iid, str(int(ct[r])), f"{res.dosage_sum[r]:.10g}"]
                    cells += [f"{avgs[r, c]:.10g}" for c in range(avgs.shape[1])]
                    if write_sums:
                        cells += [
                            f"{res.sums[r, c]:.10g}"
                            for c in range(res.sums.shape[1])
                        ]
                    fh.write("\t".join(cells) + "\n")
    return ScoreRunResult(
        num_scored=len(var_idx),
        num_unmatched=unmatched,
        num_mismatched=mismatched,
        num_samples=n_sam,
        names=list(table.names),
        sums=res.sums,
        avgs=avgs,
        allele_ct=ct,
        dosage_sum=res.dosage_sum,
        out_path=None if out is not None else out_path,
        timer=timer,
    )
