#!/usr/bin/env python
"""Benchmark harness: chr22-scale filter wall-clock vs the reference.

Bounded by construction:
  * A GLOBAL DEADLINE (env PGEN_BENCH_DEADLINE_S, default 1050 s) is
    checked before every phase; phases that don't fit are skipped and
    listed in `skipped_phases`. The compact line ALWAYS prints.
  * Phases run most-valuable-first: realistic-fixture headline ->
    keep-two -> query, then the host rows (distributed, import, cold,
    scaling, uniform fixture) and the device rows (glm, sustained step,
    matmul TFLOP/s, decode GB/s, mesh e2e), each in a subprocess with its
    own timeout that prints salvageable checkpoints.
  * The parent process never opens the GPU: it runs only host providers,
    so each device subprocess has the card to itself.
  * bench_detail.json is rewritten INCREMENTALLY after every phase, so
    a kill at any point leaves the completed rows on disk.
  * SIGTERM/SIGINT print the current compact record before exiting, so
    even an external `timeout` kill archives whatever finished.
  * stdout carries EXACTLY ONE compact JSON line; progress and errors go
    to stderr, full detail to bench_detail.json.

Headline: warm keep-all filter median on the REALISTIC-frequency
chr22-scale fixture (mostly hom-ref, like real chr22), run FIRST on a
quiet page cache, with min reported alongside.

Baselines (BASELINE.md, /root/reference/README.md:162-189):
  keep-all chr22 filter -> VCF : 30.747 s   (the flagship, output-bound)
  keep-2   chr22 filter -> VCF :  2.773 s   (metadata-scan bound)
CAVEAT: the reference numbers come from an UNSTATED AVX2 Intel dev box;
all vs_baseline ratios are cross-hardware comparisons.

Device subcommands (run as bounded subprocesses; each fails when JAX
finds no GPU, and times device work to block_until_ready after a warm-up
call):
  --kernel-bench     fused unpack + plane-form step throughput
  --device-bench     small end-to-end mesh filter
  --gemm-bench       king/glm/score/GRM/IBD/PCA matmul throughput
  --sustained-bench  full-chr22-scale production step resident in
                     device memory (on-device digest sink)
  --glm-bench        chr22-scale GWAS wall, host vs device provider

Env knobs: PGEN_BENCH_DEADLINE_S (default 1050), PGEN_BENCH_VARIANTS
(default 1103547), BENCH_RUNS (default 5), PGEN_BENCH_PROVIDER
(native or numpy, default native); PGEN_BENCH_UNIFORM/COLD/IMPORT/
SCALING/DEVICE/KERNEL/GEMM/GLM/SUSTAINED/DIST=0 to skip individual phases.
"""

import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

BASELINE_KEEP_ALL_S = 30.747
BASELINE_KEEP_TWO_S = 2.773
# Published dense peaks by jax device_kind (NVIDIA H100 SXM data sheet:
# 3.35 TB/s HBM3, 989 TFLOP/s bf16 without sparsity, at a 700 W power
# limit; the rows record the card's actual limit beside every share).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0},
}

_MAIN_PID = os.getpid()
_T_START = time.monotonic()
_T_END = _T_START + float(os.environ.get("PGEN_BENCH_DEADLINE_S", "1050"))
STATE: dict = {}
SKIPPED: list = []


def _remaining() -> float:
    return _T_END - time.monotonic()


def _log(msg: str) -> None:
    print(f"[bench +{int(time.monotonic() - _T_START)}s] {msg}",
          file=sys.stderr, flush=True)


def _flush_detail() -> None:
    (REPO / "bench_detail.json").write_text(
        json.dumps({**STATE, "skipped_phases": SKIPPED}, indent=1) + "\n"
    )


_COMPACT_KEYS = [
    "metric", "value", "unit", "vs_baseline", "headline_fixture",
    "keep_all_realistic_s", "keep_all_realistic_min_s",
    "keep_all_realistic_vs_baseline", "keep_two_wall_s",
    "keep_two_vs_baseline", "keep_all_uniform_s", "emit_gbps",
    "query_wall_s",
    "variants", "samples", "provider",
    "glm_host_wall_s", "glm_logistic_host_wall_s", "glm_device_wall_s",
    "gemm_glm_mvar_s", "gemm_score_mvar_s",
    "sustained_mvar_s", "sustained_first_call_s",
    "dist_2proc_wall_s", "dist_overhead_s",
    "dist_2host_projected_efficiency",
    "scaling_2host_projected_efficiency",
    "kernel_fused_gbps", "kernel_fused_pct_hbm_peak",
    "gemm_king_tflops", "gemm_king_pct_bf16_peak", "gpu",
    "device_e2e_wall_s", "import_gbps_median", "import_gbps_min",
    "keep_all_cold_s", "keep_all_cold_mitigated_s",
    "baseline_keep_all_s",
]


def _print_compact() -> None:
    headline = STATE.get("keep_all_realistic_s") or STATE.get(
        "keep_all_uniform_s"
    )
    if headline:
        STATE["metric"] = "chr22_keep_all_filter_wall_s"
        STATE["value"] = headline
        STATE["unit"] = "s"
        STATE["vs_baseline"] = round(BASELINE_KEEP_ALL_S / headline, 2)
        STATE["headline_fixture"] = (
            "realistic-frequency"
            if "keep_all_realistic_s" in STATE
            else "uniform"
        )
    compact = {k: STATE[k] for k in _COMPACT_KEYS if k in STATE}
    for k, v in STATE.items():
        if k.endswith("_error"):
            compact[k] = str(v)[-80:]
    if SKIPPED:
        compact["skipped"] = ",".join(SKIPPED)
    compact["detail_file"] = "bench_detail.json"
    print(json.dumps(compact), flush=True)


def _on_kill(signum, frame):  # pragma: no cover - exercised by timeouts
    if os.getpid() != _MAIN_PID:
        # forked worker inherited this handler: die quietly, never print
        # the compact line from a child (would duplicate/corrupt stdout)
        os._exit(1)
    STATE["killed_by_signal"] = signum
    try:
        _flush_detail()
    except Exception:
        pass
    _print_compact()
    os._exit(0)


def _phase(
    name: str, est_s: float, fn, gate: str | None = None,
    gate_default: str = "1",
) -> None:
    if gate and os.environ.get(gate, gate_default) != "1":
        SKIPPED.append(f"{name}(env)")
        return
    if _remaining() < est_s:
        SKIPPED.append(name)
        _log(f"skip {name}: {_remaining():.0f}s left < {est_s:.0f}s est")
        return
    _log(f"phase {name} ({_remaining():.0f}s left)")
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - record and continue
        STATE[f"{name}_error"] = str(e)[-200:]
        _log(f"{name} FAILED: {e}")
    _flush_detail()


def _timed_runs(fn, runs, warmups=1, per_run_est=12.0, presync=True):
    """Deadline-aware timed runs. os.sync() ONCE before the sequence
    (drains writeback left by earlier phases — a crossed dirty threshold
    throttles runs to disk speed), but NOT between runs: every run
    rewrites the SAME output file, so the dirty set stays bounded at one
    output size (~11 GB) and inter-run syncs would only burn the
    deadline. presync=False skips the leading sync for back-to-back
    sequences inside one phase."""
    if presync:
        os.sync()
    for _ in range(warmups):
        if _remaining() < 2 * per_run_est:
            break
        fn()
    times = []
    for _ in range(runs):
        if times and _remaining() < per_run_est + 30:
            break
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return times


def _subprocess_row(flag: str, prefix: str, timeout_s: float) -> dict:
    """Run a device bench in a subprocess bounded by its own timeout and
    the global deadline, and namespace its JSON result."""
    timeout_s = min(timeout_s, max(_remaining() - 20, 10))
    try:
        r = subprocess.run(
            [sys.executable, __file__, flag],
            capture_output=True,
            text=True,
            timeout=timeout_s,
            cwd=str(REPO),
        )
        line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        if r.returncode == 0 and line:
            return {f"{prefix}_{k}": v for k, v in json.loads(line).items()}
        return {f"{prefix}_error": (r.stderr or "no output")[-160:]}
    except subprocess.TimeoutExpired as e:
        # salvage: --gemm-bench prints a cumulative JSON line after each
        # workload, so a mid-workload kill still archives what finished
        txt = e.stdout if isinstance(e.stdout, str) else (
            e.stdout.decode(errors="replace") if e.stdout else ""
        )
        line = txt.strip().splitlines()[-1] if txt.strip() else ""
        if line:
            try:
                row = {f"{prefix}_{k}": v for k, v in json.loads(line).items()}
                row[f"{prefix}_partial_timeout_s"] = int(timeout_s)
                return row
            except ValueError:
                pass
        return {f"{prefix}_error": f"timeout({int(timeout_s)}s)"}


_DIST_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
t0 = time.perf_counter()
from pgen_tpu.parallel.distributed import _barrier, initialize_from_env
pid, n = initialize_from_env(
    coordinator_address="localhost:{port}", num_processes={n},
    process_id=int(sys.argv[1]),
)
t_init = time.perf_counter() - t0
from pgen_tpu.parallel.shard import filter_to_vcf_sharded
t0 = time.perf_counter()
filter_to_vcf_sharded({prefix!r}, out_file={out!r}, num_shards=n,
                      shard_index=pid, standalone=False)
t_filter = time.perf_counter() - t0
t0 = time.perf_counter()
_barrier()
t_barrier = time.perf_counter() - t0
print(json.dumps(dict(pid=pid, init_s=round(t_init, 3),
                      filter_s=round(t_filter, 3),
                      barrier_s=round(t_barrier, 3))))
"""


def main():
    signal.signal(signal.SIGTERM, _on_kill)
    signal.signal(signal.SIGINT, _on_kill)

    num_variants = int(os.environ.get("PGEN_BENCH_VARIANTS", 1_103_547))
    runs = int(os.environ.get("BENCH_RUNS", 5))
    provider = os.environ.get("PGEN_BENCH_PROVIDER", "native")
    if provider not in ("native", "numpy"):
        # a device provider here would open the GPU in the parent and
        # starve the device subprocesses of its memory
        raise SystemExit(
            "PGEN_BENCH_PROVIDER must be native or numpy; the device rows "
            "run in their own subprocesses"
        )
    from pgen_tpu.pipeline.device import gpu_name_and_power_limit

    STATE.update(
        {
            "variants": num_variants,
            "samples": 2504,
            "provider": provider,
            "deadline_s": round(_T_END - time.monotonic(), 0),
            "baseline_keep_all_s": BASELINE_KEEP_ALL_S,
            "baseline_keep_two_s": BASELINE_KEEP_TWO_S,
            "baseline_hardware": "unstated AVX2 Intel dev box "
            "(cross-hardware)",
            "gpu": gpu_name_and_power_limit(),
        }
    )

    from make_fixtures import ensure_chr22

    from pgen_tpu.formats.metadata import read_metadata
    from pgen_tpu.pipeline.filter import filter_to_vcf

    # ---- phase 2: realistic-frequency headline (quiet page cache) ----
    rctx: dict = {}
    uctx: dict = {}

    def realistic_headline():
        t0 = time.perf_counter()
        rprefix = str(
            ensure_chr22(
                REPO / "data" / "realistic",
                num_variants=num_variants,
                uniform_bytes=False,
            )
        )
        STATE["fixture_gen_s"] = round(time.perf_counter() - t0, 1)
        rout = f"{rprefix}.bench.vcf"
        rctx["prefix"], rctx["out"] = rprefix, rout

        def run():
            return filter_to_vcf(rprefix, out_file=rout, provider=provider)

        res = run()  # machinery warmup (imports, metadata page-in)
        STATE["output_gb"] = round(res.bytes_written / 1e9, 2)
        ts = _timed_runs(run, runs, warmups=1)
        med = statistics.median(ts)
        STATE.update(
            {
                "keep_all_realistic_s": round(med, 3),
                "keep_all_realistic_min_s": round(min(ts), 3),
                "keep_all_realistic_runs_s": [round(t, 3) for t in ts],
                "keep_all_realistic_vs_baseline": round(
                    BASELINE_KEEP_ALL_S / med, 2
                ),
                "emit_gbps": round(res.bytes_written / 1e9 / med, 2),
                "variants_per_s": int(num_variants / med),
                "host_variance_note": "this VM's throughput swings 2-3x "
                "with host contention (see runs list); min_s is the best "
                "steady-state observation, the headline stays the median",
            }
        )

    _phase("realistic_headline", 100, realistic_headline)

    # ---- phase 3: keep-two (metadata-scan bound) ---------------------
    def keep_two():
        prefix = rctx.get("prefix")
        if prefix is None:
            prefix = str(
                ensure_chr22(
                    REPO / "data" / "realistic",
                    num_variants=num_variants,
                    uniform_bytes=False,
                )
            )
        pvar = read_metadata(f"{prefix}.pvar")
        pos = pvar.get_column_strs("POS")
        p1, p2 = pos[len(pos) // 3], pos[2 * len(pos) // 3]
        q = f'POS=="{p1}" || POS=="{p2}"'
        out2 = f"{prefix}.bench2.vcf"
        ts = _timed_runs(
            lambda: filter_to_vcf(
                prefix, var_query=q, out_file=out2, provider=provider
            ),
            runs,
            warmups=2,
            per_run_est=2.0,
        )
        med = statistics.median(ts)
        STATE.update(
            {
                "keep_two_wall_s": round(med, 3),
                "keep_two_vs_baseline": round(BASELINE_KEEP_TWO_S / med, 2),
                "keep_two_runs_s": [round(t, 3) for t in ts],
            }
        )
        if os.path.exists(out2):
            os.unlink(out2)

    _phase("keep_two", 20, keep_two)

    # ---- query (the reference's other first-class command): compiled
    # predicate + vectorized fstring over all 1.1M pvar rows ----------
    def query_row():
        from pgen_tpu.pipeline.query import query_metadata

        prefix = rctx.get("prefix")
        if prefix is None:
            raise RuntimeError("no fixture from earlier phases")
        sink = open(os.devnull, "w")
        rows = {}

        def run():
            rows["n"] = query_metadata(
                prefix, 'CHROM + " " + POS + " " + ID',
                query='ALT == "G" || ALT == "T"', out=sink,
            )

        ts = _timed_runs(run, runs, warmups=2, per_run_est=2.0)
        sink.close()
        STATE.update(
            {
                "query_wall_s": round(statistics.median(ts), 3),
                "query_runs_s": [round(t, 3) for t in ts],
                "query_rows": rows.get("n"),
                "query_note": "compiled include + vectorized fstring "
                "over every pvar row; the reference re-parses an "
                "evalexpr context per row (its keep-2 metadata scan "
                "costs 2.7 s at this scale)",
            }
        )

    _phase("query", 20, query_row, gate="PGEN_BENCH_QUERY")

    # ---- distributed overhead, MEASURED: the real
    # 2-process jax.distributed end-to-end filter on this VM, with the
    # distributed-specific pieces (coordinator rendezvous + final
    # barrier) timed inside each worker. On real 2-host hardware the
    # compute halves per host (own memory bus) and ONLY init+barrier is
    # additive — so 2-host efficiency = t_compute/2 / (t_compute/2 +
    # overhead) rather than a ratio of this VM's contended walls. ------
    def distributed():
        prefix = rctx.get("prefix") or uctx.get("prefix")
        if not prefix:
            raise RuntimeError("no fixture from earlier phases")
        dout = f"{prefix}.dist.vcf"

        def run(n, port):
            script_t = _DIST_WORKER
            procs = [
                subprocess.Popen(
                    [
                        sys.executable, "-c",
                        script_t.format(
                            repo=str(REPO), prefix=prefix, out=dout,
                            port=port, n=n,
                        ),
                        str(i),
                    ],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, cwd=str(REPO),
                )
                for i in range(n)
            ]
            t0 = time.perf_counter()
            rows = []
            for p in procs:
                outs, errs = p.communicate(timeout=240)
                if p.returncode != 0:
                    raise RuntimeError(f"dist worker: {errs[-160:]}")
                rows.append(json.loads(outs.strip().splitlines()[-1]))
            return time.perf_counter() - t0, rows

        run(2, 12541)  # warm (imports, page-in, jit)
        w1, rows1 = run(1, 12542)
        w2, rows2 = run(2, 12543)
        overhead = max(r["init_s"] + r["barrier_s"] for r in rows2)
        compute2 = max(r["filter_s"] for r in rows2)
        compute1 = rows1[0]["filter_s"]
        STATE.update(
            {
                "dist_1proc_wall_s": round(w1, 3),
                "dist_2proc_wall_s": round(w2, 3),
                "dist_init_s": round(max(r["init_s"] for r in rows2), 3),
                "dist_barrier_s": round(
                    max(r["barrier_s"] for r in rows2), 3
                ),
                "dist_overhead_s": round(overhead, 3),
                "dist_2proc_filter_s": round(compute2, 3),
                "dist_1proc_filter_s": round(compute1, 3),
                "dist_2host_projected_efficiency": round(
                    (compute1 / 2.0) / (compute1 / 2.0 + overhead), 3
                ),
                "dist_note": "2 jax.distributed processes on ONE VM "
                "(shared memory bus): walls include interpreter spawn + "
                "jax import; overhead = coordinator rendezvous + final "
                "barrier, the only distributed-specific cost (output "
                "offsets are arithmetic, no data-plane collective). On "
                "real 2-host hardware each host keeps its own bus, so "
                "efficiency = (compute/2)/(compute/2 + overhead).",
            }
        )
        for f in (dout,):
            if os.path.exists(f):
                os.unlink(f)

    _phase("distributed", 70, distributed, gate="PGEN_BENCH_DIST")


    # ---- device subprocess rows, each bounded by its own timeout AND
    # the global deadline -------------------------------------------
    _phase(
        "glm_e2e", 60,
        lambda: STATE.update(_subprocess_row("--glm-bench", "glm", 420)),
        gate="PGEN_BENCH_GLM",
    )
    _phase(
        "sustained", 60,
        lambda: STATE.update(
            _subprocess_row("--sustained-bench", "sustained", 360)
        ),
        gate="PGEN_BENCH_SUSTAINED",
    )
    _phase(
        "gemm", 60,
        lambda: STATE.update(_subprocess_row("--gemm-bench", "gemm", 460)),
        gate="PGEN_BENCH_GEMM",
    )
    _phase(
        "kernel", 60,
        lambda: STATE.update(_subprocess_row("--kernel-bench", "kernel", 460)),
        gate="PGEN_BENCH_KERNEL",
    )

    def import_vcf_row():
        # median-of-N + min, same variance discipline as the filter rows
        from pgen_tpu.pipeline.vcf_import import import_vcf

        out = uctx.get("out") or rctx.get("out")
        if not out or not os.path.exists(out):
            raise RuntimeError("no VCF output from earlier phases")
        imp_prefix = str(Path(out).parent / "imported")
        vcf_gb = os.path.getsize(out) / 1e9
        ts = _timed_runs(
            lambda: import_vcf(out, out_prefix=imp_prefix, provider=provider),
            3, warmups=1, per_run_est=30.0,
        )
        med = statistics.median(ts)
        STATE.update(
            {
                "import_wall_s": round(med, 3),
                "import_runs_s": [round(t, 3) for t in ts],
                "import_gbps": round(vcf_gb / med, 2),
                "import_gbps_median": round(vcf_gb / med, 2),
                "import_gbps_min": round(vcf_gb / max(ts), 2),
                "import_gbps_max": round(vcf_gb / min(ts), 2),
            }
        )
        for suf in (".pgen", ".pvar", ".psam"):
            os.unlink(imp_prefix + suf)
        os.sync()

    _phase("import", 120, import_vcf_row, gate="PGEN_BENCH_IMPORT")


    # ---- cold rows after the evidence phases — cold mostly measures
    # the hypervisor's first-touch backing (up to ~250 s on a bad day)
    # and must not starve the kernel/gemm/distributed rows -------------
    def cold():
        prefix = uctx.get("prefix") or rctx.get("prefix")
        out = uctx.get("out") or rctx.get("out")
        if not prefix:
            raise RuntimeError("no fixture from earlier phases")
        STATE["first_touch_gbps"] = _first_touch_rate()
        if os.path.exists(out):
            os.unlink(out)
        os.sync()
        t0 = time.perf_counter()
        filter_to_vcf(prefix, out_file=out, provider=provider)
        dt = time.perf_counter() - t0
        os.sync()
        STATE.update(
            {
                "keep_all_cold_s": round(dt, 3),
                "keep_all_cold_vs_baseline": round(BASELINE_KEEP_ALL_S / dt, 2),
                "cold_note": "cold time is dominated by this VM's "
                "first-touch page backing rate (first_touch_gbps); "
                "re-touch runs at 5-8 GB/s",
            }
        )

    _phase("cold", 90, cold, gate="PGEN_BENCH_COLD")

    def cold_mitigated():
        # same fresh-output run with the env-gated
        # pre-touch (madvise(WILLNEED) + a read-ahead toucher thread,
        # pipeline/filter.py _start_pretouch) overlapping the
        # hypervisor's first-touch backing with emission. Either the
        # band narrows or the negative result is on record.
        if STATE.get("keep_all_cold_s", 0) > 160:
            SKIPPED.append("cold_mitigated(first-cold-too-slow)")
            return
        prefix = uctx.get("prefix") or rctx.get("prefix")
        out = uctx.get("out") or rctx.get("out")
        if not prefix:
            raise RuntimeError("no fixture from earlier phases")
        if os.path.exists(out):
            os.unlink(out)
        os.sync()
        os.environ["PGEN_TPU_PRETOUCH"] = "1"
        try:
            t0 = time.perf_counter()
            filter_to_vcf(prefix, out_file=out, provider=provider)
            dt = time.perf_counter() - t0
        finally:
            os.environ.pop("PGEN_TPU_PRETOUCH", None)
        os.sync()
        STATE.update(
            {
                "keep_all_cold_mitigated_s": round(dt, 3),
                "cold_mitigated_note": "fresh output with "
                "madvise(WILLNEED) + read-ahead pre-touch thread; "
                "compare keep_all_cold_s (unmitigated, same session)",
            }
        )

    # the pre-touch experiment was a reproduced negative on an earlier
    # host; default OFF so its time funds the phases that still inform
    _phase(
        "cold_mitigated", 90, cold_mitigated,
        gate="PGEN_BENCH_COLD_MITIGATED", gate_default="0",
    )

    _phase(
        "device_e2e", 60,
        lambda: STATE.update(_subprocess_row("--device-bench", "device_e2e", 460)),
        gate="PGEN_BENCH_DEVICE",
    )

    # ---- scaling (2-host wall-clock-ratio projection): SUPERSEDED as
    # 2-host evidence by the measured dist_* decomposition above; kept
    # for cross-round continuity only, and now deliberately LAST among
    # the timed phases — it therefore runs against the cold/import
    # writeback backlog, which deflates the ratio. Read scaling_2host_projected_
    # efficiency as a lower bound; dist_2host_projected_efficiency is
    # the number to quote. --------------------------------------------
    def scaling():
        from pgen_tpu.parallel.shard import (
            filter_to_vcf_parallel,
            filter_to_vcf_sharded,
        )

        prefix = uctx.get("prefix") or rctx.get("prefix")
        out = uctx.get("out") or rctx.get("out")
        sruns = 3
        filter_to_vcf_parallel(prefix, out_file=out, num_workers=2)  # warm
        w1 = _timed_runs(
            lambda: filter_to_vcf_parallel(prefix, out_file=out, num_workers=1),
            sruns, warmups=0,
        )
        w2 = _timed_runs(
            lambda: filter_to_vcf_parallel(prefix, out_file=out, num_workers=2),
            sruns, warmups=0, presync=False,
        )
        # halves run INTERLEAVED (h0,h1,h0,h1,...) so a transient slow
        # window (hypervisor writeback) cannot bias one half's min while
        # the other samples a quiet period
        def _half(si):
            return filter_to_vcf_sharded(
                prefix, out_file=f"{out}.half{si}", num_shards=2,
                shard_index=si, standalone=True,
            )

        # the 1-host numerator uses the SAME in-process sharded code path
        # (num_shards=1) so process-spawn overhead cancels out of the
        # ratio; interleaved with the halves per round
        def _full1():
            return filter_to_vcf_sharded(
                prefix, out_file=f"{out}.full1", num_shards=1,
                shard_index=0, standalone=True,
            )

        _full1(), _half(0), _half(1)  # warm (cold first-touch)
        full_ts, half_ts = [], ([], [])
        for _ in range(sruns + 2):
            if _remaining() < 50:
                break
            t0 = time.perf_counter()
            _full1()
            full_ts.append(time.perf_counter() - t0)
            for si in (0, 1):
                t0 = time.perf_counter()
                _half(si)
                half_ts[si].append(time.perf_counter() - t0)
        if not full_ts or not (half_ts[0] and half_ts[1]):
            raise RuntimeError(
                "deadline reached before a complete scaling round"
            )
        halves = [min(ts) for ts in half_ts]
        t_full1 = min(full_ts)
        os.unlink(f"{out}.full1")
        for si in (0, 1):
            os.unlink(f"{out}.half{si}")
        m1, m2 = statistics.median(w1), statistics.median(w2)
        STATE.update(
            {
                "scaling_w1_s": round(m1, 3),
                "scaling_w2_s": round(m2, 3),
                "scaling_2worker_efficiency": round(m1 / (2 * m2), 3),
                "scaling_half_shard_s": [round(t, 3) for t in halves],
                "scaling_full1_s": round(t_full1, 3),
                "scaling_2host_projected_efficiency": round(
                    t_full1 / (2 * max(halves)), 3
                ),
                "scaling_note": "2worker = 2 processes sharing this VM's "
                "ONE memory bus, which a single worker already saturates "
                "— it measures the VM, not the design. 2host projection = "
                "each half-shard timed with the machine to itself (own "
                "bus per host, zero inter-worker communication: output "
                "offsets are arithmetic), efficiency = "
                "min(in-process full)/(2*max(min half)) — both sides run "
                "the same in-process sharded code path, interleaved, so "
                "process-spawn overhead and transient slow windows "
                "cancel; the shard design itself is communication-free "
                "(offsets are arithmetic).",
            }
        )
        os.sync()

    _phase("scaling", 120, scaling, gate="PGEN_BENCH_SCALING")

    # ---- phase 4: uniform-bytes fixture (r1's original config) -------

    def uniform_keep_all():
        # keep the realistic output on disk: two 11 GB outputs coexist
        # in page cache, and deleting it here would make the NEXT bench
        # invocation's realistic warmup pay cold first-touch
        os.sync()
        prefix = str(
            ensure_chr22(
                REPO / "data", num_variants=num_variants, uniform_bytes=True
            )
        )
        out = f"{prefix}.bench.vcf"
        uctx["prefix"], uctx["out"] = prefix, out

        def run():
            return filter_to_vcf(prefix, out_file=out, provider=provider)

        ts = _timed_runs(run, max(3, runs - 2), warmups=2)
        STATE.update(
            {
                "keep_all_uniform_s": round(statistics.median(ts), 3),
                "keep_all_uniform_runs_s": [round(t, 3) for t in ts],
            }
        )

    _phase("uniform_keep_all", 120, uniform_keep_all, gate="PGEN_BENCH_UNIFORM")


    _flush_detail()
    _print_compact()


def _first_touch_rate(size=256 << 20) -> float:
    """GB/s of first-touch writes to fresh anonymous memory.

    On hypervisors with lazy page backing this is ~0.1-0.25 GB/s while
    re-touch runs at DRAM speed; the cold-output measurement pays exactly
    this tax for every fresh output page, so report it alongside."""
    import mmap

    mm = mmap.mmap(-1, size)
    chunk = bytes(16 << 20)
    t0 = time.perf_counter()
    for off in range(0, size, len(chunk)):
        mm[off : off + len(chunk)] = chunk
    dt = time.perf_counter() - t0
    mm.close()
    return round(size / dt / 1e9, 3)


def _gpu() -> "jax.Device":
    """The GPU the device rows measure; raises when JAX found none.

    Enables the persistent compile cache before the first compile, so a
    rerun reports steady-state compile time."""
    import jax

    from pgen_tpu.pipeline.device import enable_compilation_cache

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"device benchmark needs a GPU; JAX found {jax.default_backend()}"
        )
    enable_compilation_cache()
    return jax.devices()[0]


def _peaks(device) -> dict:
    """Published dense peaks of ``device`` (see PEAKS); unknown is an error."""
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise RuntimeError(
            f"no published peaks for device kind {device.device_kind!r}; "
            "add it to bench.PEAKS with its source"
        ) from None


def _device_row(device) -> dict:
    import jax

    return {"platform": device.platform, "kind": device.device_kind,
            "count": len(jax.devices())}


def _time_device(fn, *args, reps: int = 10) -> float:
    """Median wall of ``fn(*args)`` to ``block_until_ready``, after one
    warm-up call that compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _device_bench() -> dict:
    """End-to-end mesh filter on the GPU (small fixture)."""
    dev = _gpu()
    from make_fixtures import ensure_chr22

    from pgen_tpu.pipeline.mesh_filter import filter_to_vcf_mesh

    nvar = int(os.environ.get("PGEN_BENCH_DEVICE_VARIANTS", 8192))
    prefix = str(
        ensure_chr22(REPO / "data" / "devbench", num_variants=nvar, uniform_bytes=True)
    )
    out = f"{prefix}.device.vcf"
    t0 = time.perf_counter()
    filter_to_vcf_mesh(prefix, out_file=out)  # compile + first run
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = filter_to_vcf_mesh(prefix, out_file=out)
    wall = time.perf_counter() - t0
    return {
        "wall_s": round(wall, 3),
        "first_call_s": round(first, 3),
        "variants": nvar,
        "variants_per_s": int(nvar / wall),
        "out_mb": round(res.bytes_written / 1e6, 1),
        "device": _device_row(dev),
    }


def _kernel_bench() -> dict:
    """Decode throughput on the GPU: the XLA-fused unpack and the mesh
    filter's plane-form step, each timed to block_until_ready."""
    dev = _gpu()
    peak = _peaks(dev)["hbm_gbps"]
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pgen_tpu.ops.unpack import _unpack_words
    from pgen_tpu.parallel.mesh import _local_pipeline_planes

    V, R = 65536, 626
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 256, size=(V, R), dtype=np.uint8))

    # the form production uses: the decode fused into its consumer (here a
    # byte fold of all 4 codes per word), 1 B read + 1 B written per byte
    @jax.jit
    def fused(x):
        w = _unpack_words(x)
        y = w ^ (w >> 16)
        return ((y ^ (y >> 8)) & 0xFF).astype(jnp.uint8)

    dt = _time_device(fused, x)
    gbps = 2 * V * R / dt / 1e9
    out = {
        "fused_gbps": round(gbps, 1),
        "fused_pct_hbm_peak": round(100 * gbps / peak, 1),
        "device": _device_row(dev),
    }
    print(json.dumps(out), flush=True)  # checkpoint for timeout salvage

    # production geometry: the mesh filter pads the record dim to a
    # 128-byte multiple (mesh_filter.py rec_pad)
    RP = R + (-R) % 128
    xp = jnp.asarray(rng.integers(0, 256, size=(V, RP), dtype=np.uint8))
    mask = jnp.asarray(rng.random(V) < 0.5)
    step = jax.jit(lambda a, m: _local_pipeline_planes(a, m)[0])
    sdt = _time_device(step, xp, mask)
    # gather 2 B + read 1 B + write 16 B of text planes per record byte
    sgbps = 19 * V * RP / sdt / 1e9
    out.update(
        step_mvar_s=round(V / sdt / 1e6, 2),
        step_gbps=round(sgbps, 1),
        step_pct_hbm_peak=round(100 * sgbps / peak, 1),
    )
    return out


def _gemm_bench() -> dict:
    """Achieved throughput of the matmul workloads (ops/king.py Grams in
    bf16, ops/pca.py GRM and the glm/score moments in f32), one 65,536
    variant x 2,504 sample block each, timed to block_until_ready."""
    dev = _gpu()
    peak = _peaks(dev)["bf16_tflops"]
    import jax.numpy as jnp
    import numpy as np

    from pgen_tpu.ops.glm import (
        _centered,
        _glm_moments_device_jit,
        _moment_columns,
    )
    from pgen_tpu.ops.ibd import _ibd_counts_device_jit
    from pgen_tpu.ops.king import _king_counts_device_jit
    from pgen_tpu.ops.pca import _approx_pass_jit, _grm_device_jit
    from pgen_tpu.ops.score import _score_device_jit

    V, S = 65536, 2504
    R = (2 * S + 7) // 8
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 256, size=(V, R), dtype=np.uint8))
    out = {"variants": V, "samples": S, "device": _device_row(dev)}

    dt = _time_device(lambda a: _king_counts_device_jit(a, S, V), x)
    tflops = 2 * 4 * V * S * S / dt / 1e12  # 4 Grams, 2 flop/MAC
    out.update(king_tflops=round(tflops, 1),
               king_pct_bf16_peak=round(100 * tflops / peak, 1),
               king_mvar_s=round(V / dt / 1e6, 2))
    print(json.dumps(out), flush=True)

    # glm masked moments: (V,S)x(S,P) with k=2 covariates (13 columns),
    # a bandwidth workload, so the headline is variants/s
    yc, cc = _centered(rng.standard_normal(S), rng.standard_normal((S, 2)))
    pcols = jnp.asarray(_moment_columns(yc, cc).astype(np.float32))
    qcols = jnp.asarray(
        np.concatenate([yc[:, None], cc], axis=1).astype(np.float32)
    )
    dt = _time_device(
        lambda a: _glm_moments_device_jit(a, pcols, qcols, None, S, V), x
    )
    out.update(glm_mvar_s=round(V / dt / 1e6, 2),
               glm_gbps=round(V * R / dt / 1e9, 1))
    print(json.dumps(out), flush=True)

    w = jnp.asarray(rng.standard_normal((V, 4)).astype(np.float32))
    flip = jnp.asarray(np.zeros(V, dtype=bool))
    dt = _time_device(
        lambda a: _score_device_jit(a, w, flip, None, S, True, V), x
    )
    out.update(score_mvar_s=round(V / dt / 1e6, 2))
    print(json.dumps(out), flush=True)

    dt = _time_device(lambda a: _ibd_counts_device_jit(a, S, V), x)
    tflops = 2 * 5 * V * S * S / dt / 1e12  # 5 Grams
    out.update(ibd_tflops=round(tflops, 1),
               ibd_pct_bf16_peak=round(100 * tflops / peak, 1))
    print(json.dumps(out), flush=True)

    dt = _time_device(lambda a: _grm_device_jit(a, None, S, V), x)
    out.update(grm_tflops=round(2 * V * S * S / dt / 1e12, 1))
    print(json.dumps(out), flush=True)

    L = 20
    q = jnp.asarray(rng.standard_normal((S, L)).astype(np.float32))
    dt = _time_device(lambda a: _approx_pass_jit(a, q, None, S, V), x)
    out.update(pca_approx_mvar_s=round(V / dt / 1e6, 2),
               pca_approx_tflops=round(2 * 2 * V * S * L / dt / 1e12, 2))
    return out


def _sustained_bench() -> dict:
    """Full-chr22-scale mesh-filter step, resident in device memory:
    every variant streams through the stable-compaction gather and the
    plane-form text emission (parallel/mesh.py _local_pipeline_planes) in
    64Ki blocks inside one jit, folded into an on-device digest. The
    packed bytes are generated on the device (throughput does not depend
    on content at a fixed shape). optimization_barrier keeps the planes
    materialized, as production pays for them."""
    dev = _gpu()
    peak = _peaks(dev)["hbm_gbps"]
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pgen_tpu.parallel.mesh import _local_pipeline_planes

    V = int(os.environ.get("PGEN_BENCH_SUSTAINED_VARIANTS", "1103547"))
    S = 2504
    R = (2 * S + 7) // 8
    RP = R + (-R) % 128  # production record pad (mesh_filter rec_pad)
    B = 65536
    nblk = -(-V // B)
    vp = nblk * B

    t0 = time.perf_counter()
    x = jax.block_until_ready(
        jax.random.bits(jax.random.PRNGKey(7), (vp, RP), dtype=jnp.uint8)
    )
    mask0 = jnp.asarray(np.random.default_rng(0).random(B) < 0.5)
    gen_s = time.perf_counter() - t0

    @jax.jit
    def sweep(xd):
        def body(carry, blk):
            planes, cnt = _local_pipeline_planes(blk, mask0)
            p0, p1, p2, p3 = jax.lax.optimization_barrier(planes)
            y = p0 ^ p1 ^ (p2 >> 8) ^ (p3 >> 16)
            d = jnp.sum(y, dtype=jnp.uint32) + cnt.astype(jnp.uint32)
            return carry + d, None

        out, _ = jax.lax.scan(body, jnp.uint32(1), xd.reshape(nblk, B, RP))
        return out

    t0 = time.perf_counter()
    jax.block_until_ready(sweep(x))
    first = time.perf_counter() - t0
    dt = _time_device(sweep, x, reps=5)
    # per record byte: 1 read + 1 compaction write + 16 plane write +
    # 16 fold read = 34 B
    gbps = 34 * vp * RP / dt / 1e9
    return {
        "variants": vp,
        "samples": S,
        "device": _device_row(dev),
        "first_call_s": round(first + gen_s, 2),
        "mvar_s": round(vp / dt / 1e6, 2),
        "sweep_s": round(dt, 4),
        "gbps": round(gbps, 1),
        "pct_hbm_peak": round(100 * gbps / peak, 1),
    }


def _glm_bench() -> dict:
    """chr22-scale GWAS wall clock, host vs device provider: glm_pfile
    over the realistic fixture with a synthesized quantitative phenotype
    and 2 covariates."""
    dev = _gpu()
    import numpy as np

    from make_fixtures import ensure_chr22

    from pgen_tpu.formats.metadata import read_metadata
    from pgen_tpu.pipeline.glm import glm_pfile

    nvar = int(os.environ.get("PGEN_BENCH_GLM_VARIANTS", "1103547"))
    # the host leg runs a SLICE and extrapolates linearly (the moments
    # loop is block-streamed, strictly linear in V) so the phase fits
    # the deadline; the device leg runs the FULL variant count
    host_nvar = int(os.environ.get("PGEN_BENCH_GLM_HOST_VARIANTS", "262144"))
    prefix = str(
        ensure_chr22(
            REPO / "data" / "realistic", num_variants=nvar,
            uniform_bytes=False,
        )
    )
    psam = read_metadata(f"{prefix}.psam")
    iids = psam.get_column_strs("IID")
    rng = np.random.default_rng(3)
    pheno = REPO / "data" / "realistic" / "bench_pheno.tsv"
    with open(pheno, "w") as fh:
        fh.write("#IID\tQT\tC1\tC2\tCC\n")
        for iid in iids:
            fh.write(
                f"{iid}\t{rng.normal():.6g}\t{rng.normal():.6g}\t"
                f"{rng.normal():.6g}\t{1 + int(rng.random() < 0.4)}\n"
            )
    out: dict = {"variants": nvar, "samples": len(iids),
                 "device": _device_row(dev)}

    kw = dict(
        pheno_name="QT", covar_names=("C1", "C2"), pheno_file=str(pheno),
        covar_file=str(pheno), write=False,
    )
    host_nvar = min(host_nvar, nvar)
    hq = None
    if host_nvar < nvar:
        # contiguous leading slice via a row-index predicate-free bound:
        # POS in the fixture ascends, so a POS cut selects the prefix
        pvar = read_metadata(f"{prefix}.pvar")
        cut = pvar.get_column_strs("POS")[host_nvar - 1]
        hq = f'num(POS) <= {cut}'
    t0 = time.perf_counter()
    # "native" = the production host default: the C++ sparse-complement
    # moments kernel (2x the blocked-dgemm numpy path on realistic data)
    res = glm_pfile(prefix, provider="native", var_query=hq, **kw)
    host_slice_s = time.perf_counter() - t0
    scale = nvar / res.num_variants
    out["host_slice_wall_s"] = round(host_slice_s, 2)
    out["host_slice_variants"] = res.num_variants
    out["host_wall_s"] = round(host_slice_s * scale, 2)
    out["host_note"] = (
        "host_wall_s extrapolates the measured slice linearly "
        f"(x{scale:.2f}; the moments loop is block-streamed, linear in V)"
    )
    print(json.dumps(out), flush=True)  # checkpoint

    # covariate-free case/control GWAS at FULL scale: the k=0 logistic
    # collapses to 2x3-table sufficient statistics (class-sum Newton),
    # so the whole chr22 runs in seconds on host
    t0 = time.perf_counter()
    res_l = glm_pfile(
        prefix, pheno_name="CC", pheno_file=str(pheno),
        provider="native", write=False,
    )
    out["logistic_host_wall_s"] = round(time.perf_counter() - t0, 2)
    out["logistic_model"] = res_l.model
    print(json.dumps(out), flush=True)  # checkpoint

    t0 = time.perf_counter()
    res_d = glm_pfile(prefix, provider="device", **kw)
    out["device_wall_s"] = round(time.perf_counter() - t0, 2)
    out["device_stage_s"] = {
        k: round(st.seconds, 2) for k, st in res_d.timer.stages.items()
    }
    # cross-provider agreement on the fitted stats (f32 moments) over
    # the shared slice
    nb = res.num_variants
    both = np.isfinite(res.beta) & np.isfinite(res_d.beta[:nb])
    out["device_beta_max_abs_diff"] = float(
        np.max(np.abs(res.beta[both] - res_d.beta[:nb][both]), initial=0.0)
    )
    out["device_note"] = "device_wall_s covers the FULL variant count"
    return out


if __name__ == "__main__":
    if "--kernel-bench" in sys.argv:
        print(json.dumps(_kernel_bench()))
    elif "--device-bench" in sys.argv:
        print(json.dumps(_device_bench()))
    elif "--gemm-bench" in sys.argv:
        print(json.dumps(_gemm_bench()))
    elif "--sustained-bench" in sys.argv:
        print(json.dumps(_sustained_bench()))
    elif "--glm-bench" in sys.argv:
        print(json.dumps(_glm_bench()))
    else:
        main()
