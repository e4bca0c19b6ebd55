"""Re-run the OI stage from saved diagnostic files — no L2 re-read needed.

Equivalent of reference tools/readjust_OI.py:1-110, which demonstrates the
stage-boundary resume pattern (diag netCDF -> new OI -> new diag).  Two
reference defects fixed, both documented: its OI call is syntactically
broken (missing comma, readjust_OI.py:45-46) and it reads ``old_amf``/
``new_amf`` variables the diag writer never emits (driver.py writes
``aux1``/``aux2``) — we read the aux pair and pass it through.

Usage: python readjust_OI.py <diag_folder> <out_folder> [error_ctm_percent]
       [--desroziers N]       (N passes of So/Sa re-estimation, extension)
       [--desroziers-bins B]  (estimate per latitude band, extension:
                               recovers spatially-varying total error)
"""

import glob
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402

from oisat.ncwriter import read_diag_nc, write_diag_nc  # noqa: E402
from oisat.ops.oi import oi  # noqa: E402


def readjust(diag_folder, out_folder, error_ctm=50.0, desroziers_iterations=0,
             desroziers_bins=1):
    os.makedirs(out_folder, exist_ok=True)
    outputs = []
    for fname in sorted(glob.glob(os.path.join(str(diag_folder), "*.nc"))):
        print("Now processing " + fname)
        fields, tstr, attrs = read_diag_nc(fname, with_attrs=True)
        xa = np.asarray(fields["ctm_averaged_vcd_prior"], np.float64)
        y = np.asarray(fields["sat_averaged_vcd"], np.float64)
        so = np.asarray(fields["sat_averaged_error"], np.float64) ** 2
        sa = (xa * error_ctm / 100.0) ** 2
        res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so))
        y_clip = np.where(y < 0, 0.0, y)  # the innovation the OI assimilated
        nb = int(desroziers_bins)
        bins = None
        if nb > 1:
            from oisat.ops.diagnostics import lat_band_index

            bins = lat_band_index(np.asarray(fields["lat"], np.float64), nb)
        sa_total = so_total = None
        for _ in range(int(desroziers_iterations)):
            from oisat.driver import _desroziers_step

            sa_step, so_step = _desroziers_step(xa, y_clip, np.asarray(res.xb),
                                                sa, so, bins, nb)
            sa = sa * sa_step
            so = so * so_step
            sa_total = sa_step if sa_total is None else sa_total * sa_step
            so_total = so_step if so_total is None else so_total * so_step
            res = oi(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa),
                     jnp.asarray(so))
        xb = np.asarray(res.xb)
        with np.errstate(invalid="ignore", divide="ignore"):
            sf = xb / xa
        sf = np.where(np.isnan(sf) | np.isinf(sf) | (sf == 0.0), 1.0, sf)
        out = dict(fields)
        # the source file's per-cell Desroziers scale maps describe ITS
        # tuning, not this readjustment — never carry them verbatim
        # (advisor r4); persist the re-estimated maps when this run used
        # binned Desroziers, otherwise drop the fields entirely
        out.pop("desroziers_sa_scale", None)
        out.pop("desroziers_so_scale", None)
        out.update({
            "ctm_averaged_vcd_posterior": xb,
            "ak_OI": np.asarray(res.averaging_kernel),
            "error_OI": np.asarray(res.error),
            "scaling_factor": sf,
        })
        if bins is not None and sa_total is not None:
            out["desroziers_sa_scale"] = np.asarray(sa_total, np.float64)
            out["desroziers_so_scale"] = np.asarray(so_total, np.float64)
        path = os.path.join(str(out_folder), os.path.basename(fname))
        # carry the source file's persisted OI diagnostics through the
        # round trip (they are global attrs; dropping them loses the
        # original run's chi^2 / Desroziers record)
        write_diag_nc(path, out, tstr, global_attrs=attrs or None)
        outputs.append(path)
    return outputs


if __name__ == "__main__":
    args = []
    des = 0
    bins = 1
    it = iter(sys.argv[1:])
    for a in it:
        if a == "--desroziers":
            nxt = next(it, None)
            if nxt is None:
                sys.exit("--desroziers needs a value (number of passes)")
            des = int(nxt)
        elif a.startswith("--desroziers="):
            des = int(a.split("=", 1)[1])
        elif a == "--desroziers-bins":
            nxt = next(it, None)
            if nxt is None:
                sys.exit("--desroziers-bins needs a value (number of bands)")
            bins = int(nxt)
        elif a.startswith("--desroziers-bins="):
            bins = int(a.split("=", 1)[1])
        else:
            args.append(a)
    if len(args) < 2:
        sys.exit(__doc__)
    err = float(args[2]) if len(args) > 2 else 50.0
    readjust(args[0], args[1], err, desroziers_iterations=des,
             desroziers_bins=bins)
