"""Independent scalar oracle for filter/query, written directly from the
reference's observed behavior (SURVEY.md §7 byte-exactness checklist).

Deliberately structured differently from the production pipeline (per-row
string processing, a literal token dict, csv-ish splitting) so that a bug in
the shared fast-path code cannot hide in both implementations.
"""

from __future__ import annotations

import struct

TOKENS = {0: "0/0", 1: "0/1", 2: "1/1", 3: "./."}


def read_meta_lines(path):
    comments, header, rows = [], None, []
    with open(path, "r", newline="") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    i = 0
    while i < len(lines) and lines[i].startswith("#"):
        comments.append(lines[i])
        i += 1
    header = comments.pop()
    for ln in lines[i:]:
        rows.append(ln.split("\t"))
    cols = header[1:].split("\t")
    return comments, header, cols, rows


def scalar_filter_vcf(prefix, var_pred, sam_pred, source_tag="pgen-rs") -> bytes:
    """var_pred/sam_pred: callables dict->bool (or None = keep all)."""
    with open(f"{prefix}.pgen", "rb") as f:
        raw = f.read()
    assert raw[:2] == b"\x6c\x1b" and raw[2] == 0x02
    n_var, n_samp = struct.unpack_from("<II", raw, 3)
    rec_size = (2 * n_samp + 7) // 8

    pvar_comments, pvar_header, pvar_cols, pvar_rows = read_meta_lines(f"{prefix}.pvar")
    _, _, psam_cols, psam_rows = read_meta_lines(f"{prefix}.psam")
    iid = psam_cols.index("IID")

    kept_var = [
        (i, r)
        for i, r in enumerate(pvar_rows)
        if var_pred is None or var_pred(dict(zip(pvar_cols, r)))
    ]
    kept_sam = [
        (i, r)
        for i, r in enumerate(psam_rows)
        if sam_pred is None or sam_pred(dict(zip(psam_cols, r)))
    ]

    out = ["##fileformat=VCFv4.2\n", f"##source={source_tag}\n"]
    for c in pvar_comments:
        out.append(c + "\n")
    out.append(pvar_header.strip())
    out.append("\tFORMAT\t")
    out.append("\t".join(r[iid] for _, r in kept_sam))
    out.append("\n")
    for vi, vr in kept_var:
        for col in vr:
            out.append(col)
            out.append("\t")
        out.append("GT")
        rec = raw[12 + vi * rec_size : 12 + (vi + 1) * rec_size]
        for si, _ in kept_sam:
            code = (rec[si // 4] >> ((si % 4) * 2)) & 0b11
            out.append("\t")
            out.append(TOKENS[code])
        out.append("\n")
    return "".join(out).encode()


def scalar_query(prefix, fstring_fn, pred, samples=False) -> list:
    meta = f"{prefix}.psam" if samples else f"{prefix}.pvar"
    _, _, cols, rows = read_meta_lines(meta)
    out = []
    for r in rows:
        ctx = dict(zip(cols, r))
        if pred is None or pred(ctx):
            out.append(fstring_fn(ctx))
    return out


def t_sf2_oracle(t, df):
    """Independent two-sided Student-t tail via mpmath's arbitrary-
    precision regularized incomplete beta (hypergeometric evaluation —
    no shared code or algorithm with ops/glm.py's Lentz continued
    fraction). Used by the GLM oracles so a production tail bug cannot
    hide in both sides."""
    import mpmath as mp

    with mp.workdps(30):
        t = mp.mpf(abs(float(t)))
        dfm = mp.mpf(float(df))
        x = dfm / (dfm + t * t)
        return float(
            mp.betainc(dfm / 2, mp.mpf("0.5"), 0, x, regularized=True)
        )
