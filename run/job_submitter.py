"""Batch-job emitters: one SLURM/PBS job per (year, month).

Equivalent of the reference submitters (reference run/job_submitter_sbatch.py:45-68,
run/job_submitter_qsub.py:47-71), merged into one module with the scheduler
as an argument; the generated scripts keep the reference's resource shape
(170 GB / 12 h SLURM, 3 h PBS).  Months are fully independent jobs — the
reference's coarse parallelism layer, preserved for drop-in use.
"""

from __future__ import annotations

import datetime
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from oisat.control import read_control  # noqa: E402


def month_list(startdate: str, enddate: str):
    """The actual calendar sequence of (year, month) from ``startdate``
    through ``enddate`` inclusive — e.g. 2005-11..2006-02 yields exactly
    [(2005,11), (2005,12), (2006,1), (2006,2)].

    The reference's emitters instead build a min..max cartesian product of
    months x years (reference run/job_submitter_sbatch.py:29-48), which for
    a year-crossing window runs months outside the requested range in BOTH
    years (Nov 2005 -> Feb 2006 becomes 20 jobs, 16 wrong/extra).  That
    quirk is preserved only behind :func:`month_list_reference` for the
    drop-in submitter shims (bit-parity of emitted job files)."""
    y, m = int(startdate[0:4]), int(startdate[5:7])
    ye, me = int(enddate[0:4]), int(enddate[5:7])
    out = []
    while (y, m) <= (ye, me):
        out.append((y, m))
        m += 1
        if m == 13:
            y, m = y + 1, 1
    return out


def month_list_reference(startdate: str, enddate: str):
    """The reference's month set: cartesian product of the month range and
    the year range touched by the window (reference
    run/job_submitter_sbatch.py:29-48) — wrong across year boundaries,
    kept verbatim so the drop-in shims emit the same job files."""
    start = datetime.date(int(startdate[0:4]), int(startdate[5:7]), 1)
    end = datetime.date(int(enddate[0:4]), int(enddate[5:7]), 26)
    months, years = [], []
    d = start
    while d < end:
        months.append(d.month)
        years.append(d.year)
        d += datetime.timedelta(days=1)
    out = []
    for year in range(min(years), max(years) + 1):
        for month in range(min(months), max(months) + 1):
            out.append((year, month))
    return out


def sbatch_script(python_bin, num_job, year, month, debug=False):
    lines = [
        "#!/bin/bash",
        "#SBATCH -J oi_gmi",
        "#SBATCH --no-requeue",
        "#SBATCH --account=s1043",
        "#SBATCH --ntasks=1",
        f"#SBATCH --cpus-per-task={int(num_job)}",
        "#SBATCH --mem=170G",
        "#SBATCH --qos=debug" if debug else "#SBATCH -t 12:00:00",
        "#SBATCH -o oi_gmi-%j.out",
        "#SBATCH -e oi_gmi-%j.err",
        f"{python_bin} ./job.py {year} {month}",
    ]
    return "\n".join(lines) + "\n"


def qsub_script(python_bin, year, month, debug=False):
    lines = [
        "#!/bin/bash",
        "#PBS -l select=6:ncpus=4:mpiprocs=4:model=ivy",
        "#PBS -l walltime=3:00:00",
        "#PBS -N oi_gmi",
        "#PBS -j oe",
        "#PBS -m abe",
        "#PBS -o oi_gmi.out",
        "#PBS -e oi_gmi.err",
        "#PBS -W group_list=s1395",
    ]
    if debug:
        lines.append("#PBS -q devel")
    lines += ["cd $PBS_O_WORKDIR", f"{python_bin} ./job.py {year} {month}"]
    return "\n".join(lines) + "\n"


def submit(scheduler="sbatch", control="./control.yml", dry_run=False,
           reference_months=False):
    """``reference_months=True`` (the drop-in shims) reproduces the
    reference's cartesian month set; the default is the correct calendar
    sequence (:func:`month_list`)."""
    ctrl = read_control(control)
    os.makedirs("./jobs", exist_ok=True)
    scripts = []
    pick = month_list_reference if reference_months else month_list
    for year, month in pick(ctrl["start_date"], ctrl["end_date"]):
        if scheduler == "sbatch":
            body = sbatch_script(ctrl["python_bin"], ctrl["num_job"], year, month,
                                 debug=ctrl.get("debug", False))
        else:
            body = qsub_script(ctrl["python_bin"], year, month,
                               debug=ctrl.get("debug", False))
        path = f"./jobs/job_{year}_{month}.j"
        with open(path, "w") as f:
            f.write(body)
        scripts.append(path)
        if not dry_run:
            os.system(f"{scheduler} {path}")
    return scripts


if __name__ == "__main__":
    import sys

    submit(scheduler=sys.argv[1] if len(sys.argv) > 1 else "sbatch")
