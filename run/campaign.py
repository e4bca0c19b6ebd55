"""In-process campaign sweep: run many (year, month) jobs on one device.

The reference fans months out as independent SLURM/PBS jobs
(run/job_submitter_*.py) because each CPU month takes hours; on an
accelerator a month is seconds-to-minutes, so a multi-month or multi-year campaign can run as
one process with cached compilations (all months share shapes) — the
'DCN sweep driver' of SURVEY.md §7 step 8.  Month-level fault tolerance
replaces manual resubmission: a failed month is retried once, then logged
and skipped.

Usage: python campaign.py [control.yml]  (uses start_date..end_date)
"""

import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from job import load_control, read_month, run_month  # noqa: E402
from job_submitter import month_list  # noqa: E402

from oisat.utils.profiling import log, report, stage  # noqa: E402


def run_campaign(ctrl, retries: int = 1, prefetch=None):
    """Sweep months; with ``prefetch`` (control key ``campaign_prefetch``,
    default on for non-TEMPO sensors) month k+1's ``read_data`` — file IO,
    granule regrid dispatches and their H2D submits — runs in ONE
    background thread while month k's report + nc host tail executes
    (run_month fires ``prefetch_hook`` AFTER the analysis, see
    run_month's docstring).  Months are
    independent (the reference fans them out as separate scheduler jobs),
    so the overlap cannot change results; reads never overlap each other
    (at most one prefetch thread), preserving ``num_job`` semantics
    within each read.  A failed prefetch falls back to an inline read on
    the month's own attempt (and its retry path always reads inline).

    Default: ON only on multi-core hosts — on a single core the prefetch
    thread's host-side read/regrid work contends with the report leg's
    matplotlib CPU time; the control key forces either way."""
    import os

    months = month_list(ctrl["start_date"], ctrl["end_date"])
    if prefetch is None:
        prefetch = bool(ctrl.get("campaign_prefetch",
                                 (os.cpu_count() or 1) > 1))
    prefetch = prefetch and ctrl.get("sensor") != "TEMPO"
    ex = None
    pending = {}
    if prefetch and len(months) > 1:
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(max_workers=1)

    def _kick(ym):
        def kick():
            if ex is not None and ym is not None and ym not in pending:
                pending[ym] = ex.submit(read_month, ctrl, *ym)
        return kick

    failed = []
    try:
        for i, (year, month) in enumerate(months):
            nxt = months[i + 1] if i + 1 < len(months) else None
            for attempt in range(retries + 1):
                try:
                    pre = None
                    if attempt > 0 and pending:
                        # the retry reads inline; drain any in-flight
                        # prefetch first so the 'reads never overlap'
                        # invariant holds (two regrid pipelines contend
                        # for the GIL).  Results
                        # stay cached in their futures for their months.
                        for f in pending.values():
                            try:
                                f.result()
                            except Exception:
                                pass  # its month will read inline
                    fut = pending.pop((year, month), None)
                    if fut is not None and attempt == 0:
                        try:
                            pre = fut.result()
                        except Exception:
                            traceback.print_exc()
                            log("prefetch failed; reading inline",
                                year=year, month=month)
                    with stage("month", year=year, month=month):
                        run_month(ctrl, year, month, pre_read=pre,
                                  prefetch_hook=_kick(nxt))
                    log("month done", year=year, month=month)
                    break
                except Exception:
                    traceback.print_exc()
                    if attempt == retries:
                        failed.append((year, month))
                        log("month FAILED after retries", year=year, month=month)
    finally:
        if ex is not None:
            ex.shutdown(wait=True)
    log("campaign finished", months=len(months), failed=failed)
    print(report())
    return failed


if __name__ == "__main__":
    from oisat.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ctrl = load_control(sys.argv[1] if len(sys.argv) > 1 else "./control.yml")
    sys.exit(1 if run_campaign(ctrl) else 0)
