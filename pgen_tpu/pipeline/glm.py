"""`pgen-tpu glm`: per-variant association against a psam phenotype.

plink2 `--glm` analog (extension over the reference, which is a
query/filter tool — /root/reference/README.md:3-5). For every kept
variant, regression of the phenotype on [intercept, covariates,
alt-dosage] over that variant's complete cases (called genotypes) — no
imputation, exactly plink2's ADD test. Model choice follows plink2:
case/control phenotypes (1/2 plink coding, or 0/1) run LOGISTIC
(batched IRLS, ops/logistic.py; Wald Z, OR output), quantitative ones
run LINEAR (closed-form OLS, ops/glm.py; Student-t); `--linear` /
`--logistic` force either. The per-variant moments are masked matmuls
on the chosen provider (GPU matmuls on device, BLAS on host); the (k+2)-dim
solves and p-values run batched on host f64.

Phenotype / covariates come from psam columns:
  - `--pheno-name` (default PHENO1): numeric; `NA`, `na`, `.`, `-9`, and
    empty cells mark the sample missing (plink2's missing codes). A
    phenotype whose non-missing values are {0,1,2} with both 1 and 2
    present uses plink2's case/control coding: 0 = missing (dropped),
    1 = control, 2 = case -> logistic.
  - `--covar-name A,B,...`: numeric, with `M`/`F` (any case) accepted as
    1/2 for sex-style columns; missing codes as above.
Samples missing the phenotype or any covariate are dropped from the
analysis cohort (after the --include-sam/--samples predicates).

Output `{out}` (default `{prefix}.{pheno}.glm.linear`), one TSV row per
kept variant, plink2 column layout:
    #CHROM POS ID REF ALT A1 TEST OBS_CT BETA SE T_STAT P
with A1 = ALT, TEST = ADD, and NA in BETA..P when the test is
unestimable (too few complete cases or zero dosage variance).
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

MISSING_CODES = {"", ".", "NA", "na", "nan", "NaN", "-9"}


@dataclass
class GlmRunResult:
    pheno_name: str
    model: str  # "linear" | "logistic"
    num_variants: int
    num_samples: int  # analysis cohort size
    num_dropped: int  # kept samples excluded for missing pheno/covars
    n_obs: np.ndarray
    beta: np.ndarray
    se: np.ndarray
    t_stat: np.ndarray  # T_STAT (linear) / Z_STAT (logistic)
    p: np.ndarray
    out_path: str | None
    timer: StageTimer = field(default_factory=StageTimer)


def detect_model(y: np.ndarray, model: str) -> tuple:
    """plink2 model choice: case/control phenotypes run logistic.

    `model` is "auto" (logistic iff values are {1,2} plink coding or
    already {0,1}), "linear", or "logistic". Returns (model, y) with
    case/control recoded to 0/1 for the logistic path."""
    if model not in ("auto", "linear", "logistic"):
        raise ValueError(f"glm: unknown model {model!r}")
    vals = np.unique(y[~np.isnan(y)])
    is_12 = np.isin(vals, (1.0, 2.0)).all()
    is_01 = np.isin(vals, (0.0, 1.0)).all()
    if model == "linear":
        return "linear", y
    if model == "logistic":
        if is_12 and not is_01:
            return "logistic", y - 1.0
        if not np.isin(vals, (0.0, 1.0)).all():
            raise ValueError(
                "glm: --logistic needs a case/control phenotype "
                "(1/2 plink coding or 0/1)"
            )
        return "logistic", y
    if is_12 and not is_01:
        return "logistic", y - 1.0
    if is_01:
        return "logistic", y
    return "linear", y


def parse_numeric_column(values, colname: str) -> np.ndarray:
    """psam column -> f64 with NaN for missing; M/F (any case) -> 1/2."""
    out = np.empty(len(values), dtype=np.float64)
    for i, raw in enumerate(values):
        s = raw.strip()
        if s in MISSING_CODES:
            out[i] = np.nan
            continue
        try:
            out[i] = float(s)
        except ValueError:
            u = s.upper()
            if u == "M":
                out[i] = 1.0
            elif u == "F":
                out[i] = 2.0
            else:
                raise ValueError(
                    f"glm: {colname} value {raw!r} is not numeric "
                    f"(missing codes: NA . -9; sex letters M/F)"
                ) from None
    return out


def _external_column(path: str, colname: str, psam_iids) -> np.ndarray:
    """plink2 --pheno/--covar file join: a TSV with an IID column (header
    `#IID`/`IID`, or `#FID IID ...`) joined onto the psam's sample order.
    Samples absent from the file get NaN (missing). Duplicate IIDs in the
    file error (ambiguous join)."""
    raw = _external_strs(path, colname, psam_iids)
    return parse_numeric_column(raw, f"{path}:{colname}")


def _external_strs(path: str, colname: str, psam_iids) -> list:
    """The raw-string form of the --pheno/--covar join (categorical
    columns: fst --pheno-name); absent samples get 'NA'."""
    with open(path) as fh:
        header = fh.readline()
        if not header:
            raise ValueError(f"glm: {path} is empty")
        cols = header.lstrip("#").rstrip("\n").split("\t")
        if "IID" not in cols:
            raise ValueError(
                f"glm: {path} header needs an IID column (has: "
                f"{', '.join(cols)})"
            )
        iid_j = cols.index("IID")
        try:
            col_j = cols.index(colname)
        except ValueError:
            raise ValueError(
                f"glm: {path} has no column {colname!r} (has: "
                f"{', '.join(cols)})"
            ) from None
        vals = {}
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(iid_j, col_j):
                continue
            iid = parts[iid_j]
            if iid in vals:
                raise ValueError(f"glm: {path} lists IID {iid!r} twice")
            vals[iid] = parts[col_j]
    return [vals.get(iid, "NA") for iid in psam_iids]


def glm_pfile(
    pfile_prefix: str,
    pheno_name: str = "PHENO1",
    covar_names=(),
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    block_variants: int | None = None,
    model: str = "auto",
    firth: str = "fallback",
    pheno_file: str | None = None,
    covar_file: str | None = None,
    condition=(),
    write: bool = True,
    out=None,
    interaction: bool = False,
    adjust: bool = False,
    adjust_lambda: float | None = None,
    covar_variance_standardize: bool = False,
    out_base: str | None = None,
    modifier: str | None = None,
) -> GlmRunResult:
    """See the module docstring. Additional plink2 surfaces:

    pheno_file / covar_file: external TSVs joined on IID (plink2 --pheno
    / --covar); the named columns come from there instead of the psam,
    and unlisted samples are missing.
    condition: variant IDs whose alt dosage joins the covariates (plink2
    --condition/--condition-list); missing calls mean-impute over the
    analysis cohort (pinned spec — plink2 dosage semantics differ by
    input format). The conditioned variants still get tested; their own
    rows come back NA (self-collinearity), like plink2.
    modifier: plink2 --glm model modifier — genotypic (ADD + DOMDEV +
    joint GENO_2DF), hethom (HOM + HET + GENO_2DF), dominant (DOM),
    recessive (REC) — for both models; 2-df designs add a GENO_2DF row
    per variant (BETA/SE NA; the stat column holds the joint F [linear]
    or Wald chi-square [logistic], header T_OR_F_STAT /
    Z_OR_CHISQ_STAT like plink2). --adjust and the scalar result
    surface follow the FIRST test column (ADD/HOM/DOM/REC).
    """
    if adjust and out is not None:
        # validate BEFORE any table is emitted: a late error would leave
        # a complete-looking .glm table on the stream (r4 review)
        raise ValueError(
            "glm: --adjust writes a separate .adjusted file; use a "
            "file -o, not '-'"
        )
    if modifier is not None:
        from pgen_tpu.ops.glm import MODIFIER_COLS

        if modifier not in MODIFIER_COLS:
            raise ValueError(f"glm: unknown modifier {modifier!r}")
        if interaction:
            raise ValueError(
                "glm: --modifier and --interaction are mutually exclusive "
                "(pick one design)"
            )
    provider = _resolve_provider(provider)
    # "native" now reaches ops/glm.py's sparse-complement C++ moments
    # for the plain linear design; every other op under this provider
    # (interaction/modifier moments, logistic IRLS) dispatches to the
    # numpy/BLAS engine internally
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

    with timer.stage("phenotypes"):
        psam_iids = psam.get_column_strs("IID")
        if pheno_file is not None:
            y_all = _external_column(pheno_file, pheno_name, psam_iids)
        else:
            y_all = parse_numeric_column(
                psam.get_column_strs(pheno_name), pheno_name
            )
        if covar_file is not None:
            cov_all = [
                _external_column(covar_file, c, psam_iids)
                for c in covar_names
            ]
        else:
            cov_all = [
                parse_numeric_column(psam.get_column_strs(c), c)
                for c in covar_names
            ]
        complete = ~np.isnan(y_all)
        for c in cov_all:
            complete &= ~np.isnan(c)
        if model != "linear":
            # plink2 case/control coding: a {0,1,2}-valued phenotype with
            # both 1 and 2 present means 0 = missing, 1 = control,
            # 2 = case (plink2's default missing pheno code is 0 for
            # case/control). Drop the 0s so detect_model sees {1,2}.
            prov = y_all[sam_mask & complete]
            vals = np.unique(prov)
            if (
                vals.size
                and np.isin(vals, (0.0, 1.0, 2.0)).all()
                and 1.0 in vals
                and 2.0 in vals
                and 0.0 in vals
            ):
                n_zero = int((prov == 0.0).sum())
                log.warning(
                    "glm: %s looks case/control (values 0/1/2); treating "
                    "0 as missing per plink coding (%d sample(s) dropped)",
                    pheno_name, n_zero,
                )
                complete &= y_all != 0.0
        kept_before = int(sam_mask.sum())
        sam_mask = sam_mask & complete
        sam_idx = np.flatnonzero(sam_mask)
        dropped = kept_before - len(sam_idx)
    n_sam = len(sam_idx)
    k = len(covar_names)
    if n_sam < k + 3:
        raise ValueError(
            f"glm: {n_sam} analyzable samples is too few for {k} "
            f"covariate(s) (need >= {k + 3})"
        )
    if dropped:
        log.warning(
            "glm: %d sample(s) dropped for missing %s/covariates",
            dropped, pheno_name,
        )
    y = y_all[sam_idx]
    covars = (
        np.stack([c[sam_idx] for c in cov_all], axis=1)
        if k else np.zeros((n_sam, 0))
    )
    covar_labels = list(covar_names)
    condition = [c for c in (condition or ()) if c]
    if condition:
        # --condition dosage covariates: alt dosage of the named variants
        # over the analysis cohort, missing calls mean-imputed
        from pgen_tpu.ops.unpack_host import unpack_codes_numpy

        ids_all = pvar.get_column_strs("ID")
        row_of = {}
        for row, vid in enumerate(ids_all):
            if vid not in row_of:
                row_of[vid] = row
        cond_rows = []
        for vid in condition:
            row = row_of.get(vid)
            if row is None:
                raise ValueError(f"glm: --condition variant {vid!r} not found")
            cond_rows.append(row)
        codes = unpack_codes_numpy(
            records[np.asarray(cond_rows)], header.num_samples
        )[:, sam_idx]
        cal = codes != 3
        g = codes.astype(np.float64) * cal
        nc = cal.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            means = np.where(nc > 0, g.sum(axis=1) / np.maximum(nc, 1), 0.0)
        dos = np.where(cal, g, means[:, None]).T  # (S_kept, n_cond)
        covars = np.concatenate([covars, dos], axis=1)
        covar_labels += [f"dosage({v})" for v in condition]
        k = covars.shape[1]
        if n_sam < k + 3:
            raise ValueError(
                f"glm: {n_sam} analyzable samples is too few for {k} "
                f"covariate(s) incl. --condition (need >= {k + 3})"
            )
    if covar_variance_standardize and k:
        # plink2 --covar-variance-standardize: each covariate column to
        # mean 0 variance 1 over the analysis cohort (stabilizes the
        # logistic IRLS with wild-scale covariates; the ADD test is
        # invariant under this affine transform — pinned by test)
        mu = covars.mean(axis=0)
        sd = covars.std(axis=0)
        zero = sd == 0
        if zero.any():
            bad = [covar_labels[i] for i in np.flatnonzero(zero)]
            raise ValueError(
                "glm: --covar-variance-standardize: constant covariate "
                f"column(s) over the cohort: {', '.join(bad)}"
            )
        covars = (covars - mu) / sd
    if np.nanstd(y) == 0:
        raise ValueError(f"glm: phenotype {pheno_name} is constant")
    model, y = detect_model(y, model)
    if k:
        # fail fast on a globally collinear design (e.g. a constant
        # covariate): every variant would be unestimable (all-NA output)
        x0 = np.column_stack([np.ones(n_sam), covars])
        if np.linalg.matrix_rank(x0) < x0.shape[1]:
            raise ValueError(
                "glm: covariates are collinear with the intercept over the "
                f"analysis cohort (constant column among {covar_labels}?)"
            )

    with timer.stage("gather", len(var_idx) * rec):
        kept = _gather_rows(records, var_idx)

    subset = None if n_sam == header.num_samples else sam_idx.astype(np.int32)
    kw = {"block_variants": int(block_variants)} if block_variants else {}
    int_res = None
    mod_res = None
    joint_stat = joint_p = None
    if modifier is not None:
        if model == "logistic":
            from pgen_tpu.ops.logistic import glm_logistic_modifier

            with timer.stage("irls", kept.shape[0] * rec):
                lmod = glm_logistic_modifier(
                    kept, header.num_samples, y, covars, modifier,
                    provider=provider, sample_idx=subset, firth=firth, **kw,
                )
            if lmod.firth is not None and lmod.firth.any():
                log.info(
                    "glm: %d site(s) fit by Firth regression (%s)",
                    int(lmod.firth.sum()), firth,
                )

            class _LModView:  # normalize z_stat -> t_stat column name
                n_obs = lmod.n_obs
                beta = lmod.beta
                se = lmod.se
                t_stat = lmod.z_stat
                p = lmod.p

            mod_res = _LModView()
            joint_stat, joint_p = lmod.joint_stat, lmod.joint_p
        else:
            from pgen_tpu.ops.glm import glm_linear_modifier

            with timer.stage("moments", kept.shape[0] * rec):
                mod_res = glm_linear_modifier(
                    kept, header.num_samples, y, covars, modifier,
                    provider=provider, sample_idx=subset, **kw,
                )
            joint_stat, joint_p = mod_res.joint_stat, mod_res.joint_p

        class _ModView:  # first test column drives the scalar surface
            n_obs = mod_res.n_obs
            beta = mod_res.beta[:, 0]
            se = mod_res.se[:, 0]
            t_stat = mod_res.t_stat[:, 0]
            p = mod_res.p[:, 0]

        res = _ModView()
        stat = res.t_stat
    elif interaction:
        # plink2 `--glm interaction`: the design grows to [1, C, g, g*C];
        # each dosage term (ADD + every ADDxC_i) is reported as its own
        # TEST row. Linear runs the closed-form interaction OLS; logistic
        # runs the interaction IRLS with the same firth-fallback rescue
        # as the base model (r5; the hat quadratic splits over the
        # interaction design's A blocks).
        if k == 0:
            raise ValueError(
                "glm: --interaction needs at least one covariate"
            )
        if n_sam < 2 * k + 3:
            raise ValueError(
                f"glm: {n_sam} analyzable samples is too few for the "
                f"interaction design (need >= {2 * k + 3})"
            )
        if model == "logistic":
            from pgen_tpu.ops.logistic import glm_logistic_interaction

            with timer.stage("irls", kept.shape[0] * rec):
                lint = glm_logistic_interaction(
                    kept, header.num_samples, y, covars,
                    provider=provider, sample_idx=subset, firth=firth,
                    **kw,
                )
            if lint.firth is not None and lint.firth.any():
                log.info(
                    "glm: %d site(s) fit by Firth regression (%s)",
                    int(lint.firth.sum()), firth,
                )

            class _LIntView:  # normalize z_stat -> t_stat column name
                n_obs = lint.n_obs
                beta = lint.beta
                se = lint.se
                t_stat = lint.z_stat
                p = lint.p

            int_res = _LIntView()
        else:
            from pgen_tpu.ops.glm import glm_int_moments, glm_solve_interaction

            with timer.stage("moments", kept.shape[0] * rec):
                im = glm_int_moments(
                    kept, header.num_samples, y, covars, provider=provider,
                    sample_idx=subset, **kw,
                )
            with timer.stage("solve"):
                int_res = glm_solve_interaction(
                    im, k, covar_means=covars.mean(axis=0)
                )

        class _AddView:  # ADD column drives the scalar result surface
            n_obs = int_res.n_obs
            beta = int_res.beta[:, 0]
            se = int_res.se[:, 0]
            t_stat = int_res.t_stat[:, 0]
            p = int_res.p[:, 0]

        res = _AddView()
        stat = res.t_stat
    elif model == "logistic":
        from pgen_tpu.ops.logistic import glm_logistic

        with timer.stage("irls", kept.shape[0] * rec):
            lres = glm_logistic(
                kept, header.num_samples, y, covars, provider=provider,
                sample_idx=subset, firth=firth, **kw,
            )
        if lres.firth is not None and lres.firth.any():
            log.info(
                "glm: %d site(s) fit by Firth regression (%s)",
                int(lres.firth.sum()), firth,
            )
        res = lres  # n_obs/beta/se/z_stat/p (stat name differs only)
        stat = lres.z_stat
    else:
        from pgen_tpu.ops.glm import glm_moments, glm_solve

        with timer.stage("moments", kept.shape[0] * rec):
            moments = glm_moments(
                kept, header.num_samples, y, covars, provider=provider,
                sample_idx=subset, **kw,
            )
        with timer.stage("solve"):
            res = glm_solve(moments, k)
        stat = res.t_stat

    # explicit -o wins; out_base (multi-pheno CLI) appends the model
    # suffix once it is known, matching the documented
    # {base}.{pheno}.glm.{model} layout so linear/logistic runs of the
    # same phenotype never collide on one name
    if out_file is not None:
        out_path = out_file
    elif out_base is not None:
        out_path = f"{out_base}.glm.{model}"
    else:
        out_path = f"{pfile_prefix}.{pheno_name}.glm.{model}"
    if write:
        with timer.stage("emit"):
            import contextlib

            chroms = pvar.get_column_strs("CHROM")
            poss = pvar.get_column_strs("POS")
            ids = pvar.get_column_strs("ID")
            refs = pvar.get_column_strs("REF")
            alts = pvar.get_column_strs("ALT")
            cm = (
                contextlib.nullcontext(out)
                if out is not None
                else open(out_path, "w")
            )
            from pgen_tpu.ops.glm import JOINT_TEST_NAME

            has_joint = joint_stat is not None
            if model == "logistic":
                statname = "Z_OR_CHISQ_STAT" if has_joint else "Z_STAT"
                cols = f"OR\tLOG(OR)_SE\t{statname}\tP"
            else:
                statname = "T_OR_F_STAT" if has_joint else "T_STAT"
                cols = f"BETA\tSE\t{statname}\tP"
            if interaction:
                tests = ["ADD"] + [f"ADDx{lab}" for lab in covar_labels]
            elif modifier is not None:
                from pgen_tpu.ops.glm import MODIFIER_TESTS

                tests = list(MODIFIER_TESTS[modifier])
            else:
                tests = ["ADD"]
            multi = int_res if interaction else mod_res
            with cm as fh:
                fh.write(
                    f"#CHROM\tPOS\tID\tREF\tALT\tA1\tTEST\tOBS_CT\t{cols}\n"
                )
                for r, v in enumerate(var_idx):
                    v = int(v)
                    prefix_row = (
                        f"{chroms[v]}\t{poss[v]}\t{ids[v]}\t{refs[v]}\t"
                        f"{alts[v]}\t{alts[v]}"
                    )
                    for ti, tname in enumerate(tests):
                        if multi is not None:
                            b = multi.beta[r, ti]
                            s_ = multi.se[r, ti]
                            st = multi.t_stat[r, ti]
                            pv = multi.p[r, ti]
                        else:
                            b, s_, st, pv = (
                                res.beta[r], res.se[r], stat[r], res.p[r]
                            )
                        if np.isnan(b):
                            tail = "NA\tNA\tNA\tNA"
                        elif model == "logistic":
                            tail = (
                                f"{np.exp(b):.6g}\t{s_:.6g}\t"
                                f"{st:.6g}\t{pv:.6g}"
                            )
                        else:
                            tail = f"{b:.6g}\t{s_:.6g}\t{st:.6g}\t{pv:.6g}"
                        fh.write(
                            f"{prefix_row}\t{tname}\t{res.n_obs[r]}\t"
                            f"{tail}\n"
                        )
                    if has_joint:
                        # plink2 joint-test row: BETA/SE are NA; the stat
                        # column carries F (linear) / chi2 (logistic)
                        js, jp = joint_stat[r], joint_p[r]
                        jtail = (
                            "NA\tNA\tNA\tNA" if np.isnan(js)
                            else f"NA\tNA\t{js:.6g}\t{jp:.6g}"
                        )
                        fh.write(
                            f"{prefix_row}\t{JOINT_TEST_NAME}\t"
                            f"{res.n_obs[r]}\t{jtail}\n"
                        )
    if adjust:
        # plink2 --adjust: the ADD test's p-values, corrected; rows
        # sorted by UNADJ ascending, NA rows excluded
        from pgen_tpu.ops.adjust import adjust_pvalues

        with timer.stage("adjust"):
            adj = adjust_pvalues(res.p, stat, lambda_gc=adjust_lambda)
        adj_path = f"{out_path}.adjusted"
        log.info(
            "glm --adjust: genomic inflation est. lambda = %.6g over %d "
            "tested variant(s)", adj.lambda_gc, len(adj.order),
        )
        if write:
            chroms = pvar.get_column_strs("CHROM")
            poss = pvar.get_column_strs("POS")
            ids = pvar.get_column_strs("ID")
            refs = pvar.get_column_strs("REF")
            alts = pvar.get_column_strs("ALT")
            with open(adj_path, "w") as fh:
                fh.write(
                    "#CHROM\tPOS\tID\tREF\tALT\tA1\tUNADJ\tGC\tBONF\t"
                    "HOLM\tSIDAK_SS\tSIDAK_SD\tFDR_BH\tFDR_BY\n"
                )
                for i, r in enumerate(adj.order):
                    v = int(var_idx[r])
                    cells = "\t".join(
                        f"{col[i]:.6g}"
                        for col in (
                            adj.unadj, adj.gc, adj.bonf, adj.holm,
                            adj.sidak_ss, adj.sidak_sd, adj.fdr_bh,
                            adj.fdr_by,
                        )
                    )
                    fh.write(
                        f"{chroms[v]}\t{poss[v]}\t{ids[v]}\t{refs[v]}\t"
                        f"{alts[v]}\t{alts[v]}\t{cells}\n"
                    )

    return GlmRunResult(
        pheno_name=pheno_name,
        model=model,
        num_variants=len(var_idx),
        num_samples=n_sam,
        num_dropped=dropped,
        n_obs=res.n_obs,
        beta=res.beta,
        se=res.se,
        t_stat=stat,
        p=res.p,
        out_path=None if out is not None else out_path,
        timer=timer,
    )
