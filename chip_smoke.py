#!/usr/bin/env python
"""Proof that the device provider runs on the GPU, end to end through the CLI.

    python chip_smoke.py              # one GPU: phases a-e below
    python chip_smoke.py --chips 4    # four GPUs: the mesh paths only

Every run goes through ``pgen_tpu.cli.main(argv)``, the function that
``python -m pgen_tpu.cli`` and the ``pgen-tpu`` script call, inside this one
process: a JAX process reserves most of a card's memory when it first uses
it, so a second process on the same card would fail. Each device run is
compared with a reference provider on the same fixture; any failure raises
and the script exits non-zero without printing a result. The last line of
stdout is ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Phases on one card:
  a. environment: the JAX backend must be a GPU; the card's name and power
     limit, the JAX version and XLA_FLAGS.
  b. fixtures: chr22 shape (1,103,547 variants x 2,504 samples, seed 22,
     realistic genotype frequencies) plus 131,072- and 16,384-variant
     fixtures of the same width, generated into the gitignored data/.
  c. filter: the device mesh filter (predicate, compaction, text planes all
     on the device) against native bytes, keeping ALT == "G" (about a
     quarter of the records), then the same with two samples kept.
  d. analytics at full sample width: linear glm with two covariates on
     the full fixture (against native), score with a weight for every
     variant (against numpy), king and pca --approx on the 131,072-variant
     fixture (against numpy; the host reference is quadratic in samples).
  e. coverage on the 16,384-variant fixture: every other subcommand whose
     --provider takes device, plus filter --out-format pgen/bed, the
     sharded filter's device emitter, logistic glm, the glm modifier and
     interaction moments and exact pca, each against numpy.

With --chips 4 the script runs only what exists across cards, on the
131,072-variant fixture: the device filter over the 4-GPU mesh against
native bytes, king, genome, glm and score through their mesh dispatch, and
pca (GRM mesh) and pca --approx, each against numpy.

Tolerances (device against reference):
  * exact bytes: filter output, every integer-count report (stats, freq,
    missing, hardy, het, gcount, fst, roh, export, annotate --fill-info),
    king and genome (bf16 0/1 indicators with f32 accumulation are exact
    below 2^24 variants), pgen/bed/import output;
  * rtol = atol = 2e-5 on f32 moment sums (score averages, ld r2): every
    f32 device matmul asks for Precision.HIGHEST, so none runs in TF32;
  * rtol 1e-3 on pca eigenvalues (f32 Gram passes against f64 host ones;
    eigenvectors of near-equal eigenvalues may rotate, so they are checked
    for shape, finiteness and unit norm only);
  * glm BETA/SE/statistics/P: rtol 1e-3, atol 1e-5. The device moments are
    f32 (about 1e-6 relative), the solves amplify that by the design's
    condition number, and the device logistic fit stops at a step
    tolerance of 1e-5 (ops/logistic.py); tests/test_glm.py holds the same
    bound.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DATA = REPO / "data"
WORK = DATA / "smoke"

FULL_VARIANTS = 1_103_547
KING_VARIANTS = 131_072
COVER_VARIANTS = 16_384
NUM_SAMPLES = 2504
SEED = 22

EXACT = None
MOMENTS = (2e-5, 2e-5)
GLM = (1e-3, 1e-5)
EIGENVALUE_RTOL = 1e-3


class SmokeError(AssertionError):
    """A device result disagreed with its reference, or a run failed."""


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def check_environment(chips: int) -> dict:
    """Phase a: a GPU backend with ``chips`` cards, or fail."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SmokeError(f"JAX found no GPU (backend {backend!r})")
    from pgen_tpu.pipeline.device import device_backend, gpu_name_and_power_limit

    device_backend()  # enables the compile cache before the first compile
    devices = jax.devices()
    if len(devices) != chips:
        raise SmokeError(f"want {chips} GPU(s), JAX sees {len(devices)}")
    smi = gpu_name_and_power_limit()
    if not smi:
        raise SmokeError("nvidia-smi gave no card name and power limit")
    for line in smi.splitlines():
        print(f"[a] nvidia-smi: {line}")
    print(f"[a] jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"count {len(devices)}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def make_fixtures(which) -> dict:
    """Phase b: seeded fixtures of the chr22 shape under data/."""
    from make_fixtures import ensure_chr22

    out = {}
    for name, nvar in which:
        t0 = time.perf_counter()
        base = DATA if name == "full" else WORK / f"fixture_{nvar}"
        out[name] = str(ensure_chr22(base, num_variants=nvar,
                                     num_samples=NUM_SAMPLES, seed=SEED))
        print(f"[b] fixture {name}: {nvar} variants x {NUM_SAMPLES} samples "
              f"at {out[name]}: generation {time.perf_counter() - t0:.2f} s")
    return out


def write_inputs(prefix: str) -> dict:
    """Seeded phenotype/covariate table and score weights for ``prefix``."""
    from pgen_tpu.formats.metadata import read_metadata

    rng = np.random.default_rng(SEED)
    iids = read_metadata(f"{prefix}.psam").get_column_strs("IID")
    pheno = Path(f"{prefix}.smoke_pheno.tsv")
    qt, c1, c2 = rng.standard_normal((3, len(iids)))
    pop = rng.choice(["AFR", "EUR", "EAS"], len(iids))
    cc = 1 + (rng.random(len(iids)) < 0.4)
    pheno.write_text("#IID\tQT\tC1\tC2\tPOP\tCC\n" + "".join(
        f"{i}\t{a:.6g}\t{b:.6g}\t{c:.6g}\t{p}\t{d}\n"
        for i, a, b, c, p, d in zip(iids, qt, c1, c2, pop, cc)
    ))
    pvar = read_metadata(f"{prefix}.pvar")
    ids = pvar.get_column_strs("ID")
    ref, alt = pvar.get_column_strs("REF"), pvar.get_column_strs("ALT")
    flip = rng.random(len(ids)) < 0.5
    w = rng.standard_normal(len(ids))
    weights = Path(f"{prefix}.smoke_weights.tsv")
    weights.write_text("ID\tA1\tW\n" + "".join(
        f"{i}\t{r if f else a}\t{x:.6g}\n"
        for i, r, a, f, x in zip(ids, ref, alt, flip, w)
    ))
    return {"pheno": str(pheno), "weights": str(weights)}


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while chunk := fh.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def compare_tables(dev: Path, ref: Path, rtol: float, atol: float) -> float:
    """Whitespace-split tables: equal text, or numbers within
    ``atol + rtol * |ref|``. Returns the largest share of the tolerance
    used."""
    worst = 0.0
    with open(dev) as fd, open(ref) as fr:
        for n, (a, b) in enumerate(zip(fd, fr, strict=True), 1):
            if a == b:
                continue
            fa, fb = a.split(), b.split()
            if len(fa) != len(fb):
                raise SmokeError(f"{dev.name} line {n}: {a!r} vs {b!r}")
            for x, y in zip(fa, fb):
                if x == y:
                    continue
                try:
                    u, v = float(x), float(y)
                except ValueError:
                    raise SmokeError(
                        f"{dev.name} line {n}: {x!r} vs {y!r}") from None
                bound = atol + rtol * abs(v)
                if not abs(u - v) <= bound:
                    raise SmokeError(
                        f"{dev.name} line {n}: {x} vs {y} beyond "
                        f"rtol {rtol} atol {atol}")
                worst = max(worst, abs(u - v) / bound if bound else 0.0)
    return worst


def compare_dirs(dev: Path, ref: Path, tol) -> str:
    names = sorted(p.name for p in dev.iterdir())
    if names != sorted(p.name for p in ref.iterdir()) or not names:
        raise SmokeError(f"output files differ: {names} vs "
                         f"{sorted(p.name for p in ref.iterdir())}")
    notes = []
    for name in names:
        a, b = dev / name, ref / name
        if tol is EXACT or name.endswith((".pgen", ".bed")):
            ha, hb = sha256(a), sha256(b)
            if ha != hb:
                raise SmokeError(f"{name}: sha256 {ha} != {hb}")
            notes.append(f"{name} {a.stat().st_size} B sha256 {ha[:16]} equal")
        else:
            used = compare_tables(a, b, *tol)
            notes.append(f"{name} within rtol {tol[0]} atol {tol[1]} "
                         f"(max {used:.3f} of tolerance)")
    return "; ".join(notes)


class Runner:
    """Runs CLI commands in this process and compares device output with a
    reference provider's."""

    def __init__(self):
        from pgen_tpu.cli import main

        self.main = main
        self.clock = CompileClock()

    def run(self, argv, stdout: Path | None = None):
        """One CLI call; returns (wall seconds, compile seconds)."""
        c0, t0 = self.clock.seconds, time.perf_counter()
        with contextlib.ExitStack() as stack:
            if stdout is not None:
                fh = stack.enter_context(open(stdout, "w"))
                stack.enter_context(contextlib.redirect_stdout(fh))
            rc = self.main([str(a) for a in argv])
        if rc != 0:
            raise SmokeError(f"pgen-tpu {' '.join(map(str, argv))} -> exit {rc}")
        return time.perf_counter() - t0, self.clock.seconds - c0

    def versus(self, phase, name, argv, ref_provider, tol=EXACT,
               stdout=False, check=None):
        """Run ``argv(out_dir)`` with --provider device and with
        ``ref_provider``, each into its own directory, and compare every
        file written (``check(dev_dir, ref_dir)`` instead, when given)."""
        dirs = {}
        times = {}
        for prov in ("device", ref_provider):
            d = WORK / "out" / f"{name.replace(' ', '_')}.{prov}"
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            dirs[prov] = d
            times[prov] = self.run(
                [*argv(d), "--provider", prov],
                stdout=d / "stdout.txt" if stdout else None,
            )
        detail = (check or (lambda a, b: compare_dirs(a, b, tol)))(
            dirs["device"], dirs[ref_provider])
        (dw, dc), (rw, _) = times["device"], times[ref_provider]
        print(f"[{phase}] {name}: ok, device vs {ref_provider}: {detail} | "
              f"device wall {dw:.2f} s (compile {dc:.2f} s), "
              f"{ref_provider} wall {rw:.2f} s", flush=True)
        for d in dirs.values():
            shutil.rmtree(d)


def check_pca(rtol: float):
    def check(dev: Path, ref: Path) -> str:
        (ev,) = [p.name for p in dev.iterdir() if p.name.endswith(".eigenval")]
        used = compare_tables(dev / ev, ref / ev, rtol, 0.0)
        vec = ev[: -len(".eigenval")] + ".eigenvec"
        rows = (dev / vec).read_text().splitlines()
        want = (ref / vec).read_text().splitlines()
        if len(rows) != len(want) or rows[0] != want[0]:
            raise SmokeError(f"{vec}: shape or header differs")
        x = np.array([r.split()[1:] for r in rows[1:]], dtype=np.float64)
        if not np.isfinite(x).all():
            raise SmokeError(f"{vec}: non-finite values")
        norms = np.linalg.norm(x, axis=0)
        if not np.allclose(norms, 1.0, atol=1e-3):
            raise SmokeError(f"{vec}: column norms {norms}")
        return (f"eigenvalues within rtol {rtol} (max {used:.3f} of "
                f"tolerance); eigenvectors {x.shape} finite, unit norm")

    return check


def filter_phase(r: Runner, phase: str, prefix: str):
    two = 'IID == "per7" || IID == "per2000"'
    for name, extra in (("filter ALT==G", []),
                        ("filter ALT==G two samples", ["--include-sam", two])):
        r.versus(phase, name, lambda d, e=extra: [
            "filter", prefix, "--include-var", 'ALT == "G"', *e,
            "-o", d / "out.vcf"], "native")


def single_card(r: Runner):
    fx = make_fixtures([("full", FULL_VARIANTS), ("king", KING_VARIANTS),
                        ("cover", COVER_VARIANTS)])
    full, king, cover = fx["full"], fx["king"], fx["cover"]
    ins = {k: write_inputs(p) for k, p in fx.items()}

    filter_phase(r, "c", full)

    ph, w = ins["full"]["pheno"], ins["full"]["weights"]
    r.versus("d", "glm linear k=2", lambda d: [
        "glm", full, "--pheno", ph, "--pheno-name", "QT", "--covar", ph,
        "--covar-name", "C1,C2", "-o", d / "out.glm"], "native", GLM)
    r.versus("d", "score", lambda d: [
        "score", full, "--score", w, "-o", d / "out.sscore"], "numpy",
        MOMENTS)
    r.versus("d", "king", lambda d: [
        "king", king, "-o", d / "out.kin0"], "numpy")
    r.versus("d", "pca --approx", lambda d: [
        "pca", king, "--approx", "-k", "10", "-o", d / "out"], "numpy",
        check=check_pca(EIGENVALUE_RTOL))

    coverage(r, cover, ins["cover"])


def coverage(r: Runner, p: str, ins: dict):
    ph, w = ins["pheno"], ins["weights"]
    two = 'IID == "per3" || IID == "per1234"'
    e = "e"
    r.versus(e, "stats", lambda d: ["stats", p, "--per-sample"], "numpy",
             stdout=True)
    for rep in ("freq", "missing", "hardy", "het", "gcount"):
        r.versus(e, rep, lambda d, rep=rep: [rep, p, "-o", d / "out"],
                 "numpy")
    r.versus(e, "fst", lambda d: [
        "fst", p, "--pheno", ph, "--pheno-name", "POP", "--report-variants",
        "-o", d / "out"], "numpy")
    r.versus(e, "genome", lambda d: ["genome", p, "-o", d / "out.genome"],
             "numpy")
    r.versus(e, "roh", lambda d: ["roh", p, "-o", d / "out"], "numpy")
    r.versus(e, "export A", lambda d: ["export", p, "A", "-o", d / "out.raw"],
             "numpy")
    r.versus(e, "prune", lambda d: [
        "prune", p, "--indep-pairwise", "50", "5", "0.5", "-o", d / "out"],
        "numpy")
    r.versus(e, "ld", lambda d: [
        "ld", p, "--ld-window-r2", "0", "-o", d / "out.ld"], "numpy", MOMENTS)
    r.versus(e, "annotate --fill-info", lambda d: [
        "annotate", p, "--fill-info", "all", "-o", d / "out"], "numpy")
    vcf = WORK / "cover.vcf"
    r.run(["filter", p, "--provider", "native", "-o", vcf])
    r.versus(e, "import", lambda d: ["import", vcf, "-o", d / "out"], "numpy")
    vcf.unlink()
    for fmt in ("pgen", "bed"):
        r.versus(e, f"filter --out-format {fmt}", lambda d, fmt=fmt: [
            "filter", p, "--include-sam", two, "--include-var", 'ALT != "T"',
            "--out-format", fmt, "-o", d / "out"], "numpy")
    for name, extra in (("filter --shards 2", []),
                        ("filter --shards 2 two samples",
                         ["--include-sam", two])):
        r.versus(e, name, lambda d, x=extra: [
            "filter", p, "--shards", "2", *x, "-o", d / "out.vcf"], "numpy")
    glm = ["--pheno", ph, "--covar", ph, "--covar-name", "C1,C2"]
    r.versus(e, "glm logistic", lambda d: [
        "glm", p, *glm, "--pheno-name", "CC", "-o", d / "out.glm"], "numpy",
        GLM)
    r.versus(e, "glm --modifier genotypic", lambda d: [
        "glm", p, *glm, "--pheno-name", "QT", "--modifier", "genotypic",
        "-o", d / "out.glm"], "numpy", GLM)
    r.versus(e, "glm --interaction", lambda d: [
        "glm", p, *glm, "--pheno-name", "QT", "--interaction",
        "-o", d / "out.glm"], "numpy", GLM)
    r.versus(e, "score --no-mean-imputation", lambda d: [
        "score", p, "--score", w, "--no-mean-imputation",
        "-o", d / "out.sscore"], "numpy", MOMENTS)
    r.versus(e, "pca", lambda d: ["pca", p, "-k", "4", "-o", d / "out"],
             "numpy", check=check_pca(EIGENVALUE_RTOL))


def four_cards(r: Runner):
    fx = make_fixtures([("king", KING_VARIANTS)])
    p = fx["king"]
    ins = write_inputs(p)
    ph, w = ins["pheno"], ins["weights"]
    m = "mesh"
    filter_phase(r, m, p)
    r.versus(m, "king", lambda d: ["king", p, "-o", d / "out.kin0"], "numpy")
    r.versus(m, "genome", lambda d: ["genome", p, "-o", d / "out.genome"],
             "numpy")
    r.versus(m, "glm linear k=2", lambda d: [
        "glm", p, "--pheno", ph, "--pheno-name", "QT", "--covar", ph,
        "--covar-name", "C1,C2", "-o", d / "out.glm"], "numpy", GLM)
    r.versus(m, "score", lambda d: [
        "score", p, "--score", w, "-o", d / "out.sscore"], "numpy", MOMENTS)
    r.versus(m, "pca (GRM)", lambda d: ["pca", p, "-k", "10", "-o", d / "out"],
             "numpy", check=check_pca(EIGENVALUE_RTOL))
    r.versus(m, "pca --approx", lambda d: [
        "pca", p, "--approx", "-k", "10", "-o", d / "out"], "numpy",
        check=check_pca(EIGENVALUE_RTOL))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="1: the full single-card smoke; 4: the mesh paths "
                         "on four cards only.")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    t0 = time.perf_counter()
    device = check_environment(args.chips)
    WORK.mkdir(parents=True, exist_ok=True)
    r = Runner()
    (four_cards if args.chips == 4 else single_card)(r)
    shutil.rmtree(WORK / "out", ignore_errors=True)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.2f} s "
          f"(compile {r.clock.seconds:.2f} s)")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
