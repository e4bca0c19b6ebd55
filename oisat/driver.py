"""The ``oisatgmi`` session API — drop-in equivalent of the reference driver
(reference oisatgmi/driver.py:17-227): ``read_data → recal_amf/conv_ak/
cal_pwv → average → bias_correct → oi → reporting/write_to_nc/savedaily``.

State attribute names match the reference so downstream tooling
(``tools/readjust_OI.py`` etc.) works unchanged; the numerics underneath
run on the accelerator through :mod:`oisat.ops`.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from oisat.obs_operators import ak_conv_gosat, ak_conv_mopitt, amf_recal, pwv_calculator
from oisat.ops.averaging import averaging
from oisat.ops.oi import oi as oi_op
from oisat.ncwriter import write_diag_nc
from oisat.utils.profiling import stage

__all__ = ["oisatgmi", "BIAS_CORRECTIONS"]


# (sensor, gas) -> (offset, slope): corrected = (vcd - offset) / slope.
# Regression coefficients from the validation studies cited in the reference
# (reference driver.py:68-99).
BIAS_CORRECTIONS = {
    ("TROPOMI", "NO2"): (0.32, 0.66),
    ("TROPOMI", "HCHO"): (0.90, 0.59),
    ("OMI", "NO2"): (0.32, 0.63),
    ("OMI", "HCHO"): (0.821, 0.79),
}


class _DeferredStack:
    """Marker for a month-assembly field whose per-granule leaves are
    device arrays: the stack happens inside :func:`_stack_fields` so the
    whole assembly is ONE compiled program + ONE dispatch (an eager
    ``jnp.stack`` per field costs G expand_dims dispatches + a concatenate
    each, and each distinct field signature is a separate compiled
    program — the compile census attributed the residual eager assembly
    programs of the cold month here)."""

    __slots__ = ("arrays",)

    def __init__(self, arrays):
        self.arrays = tuple(arrays)


@jax.jit
def _stack_fields(lists):
    """Stack every field of a device-granule month in one program."""
    return tuple(jnp.stack(t) for t in lists)


def _settled_valid(dv):
    """Resolve deferred ``_device_valid`` scalars to host booleans with ONE
    batched device pull (an eager per-scalar ``bool()`` would cost a
    device round trip each).  ``dv`` holds one entry per granule: the device scalar,
    or None for granules that carry no flag (host-mode regrid already
    applied the off-domain check) — those resolve to True."""
    if not any(v is not None for v in dv):
        return [True] * len(dv)
    flags = iter(np.asarray(_stack_fields(
        (tuple(v for v in dv if v is not None),))[0]))
    return [True if v is None else bool(next(flags)) for v in dv]


def _settle_stacks(inputs):
    """Replace the :class:`_DeferredStack` fields of an assembled month
    NamedTuple with their device stacks — one jit call for all of them."""
    idxs = [i for i, v in enumerate(inputs) if isinstance(v, _DeferredStack)]
    if not idxs:
        return inputs
    stacked = _stack_fields(tuple(inputs[i].arrays for i in idxs))
    vals = list(inputs)
    for i, s in zip(idxs, stacked):
        vals[i] = s
    return type(inputs)(*vals)


def _pack_month_pull(out, with_oi: bool):
    """Pack every host-bound result of the fused month into ONE
    ``(K+1, H, W)`` array (the last plane carries the scalars: reg_factor
    + the innovation diagnostics, NaN-padded).  The driver then retrieves
    the whole month with a single D2H transfer — the eager per-attribute
    ``np.asarray``/``float()`` pulls this replaces were ~17 sequential
    device round trips."""
    fields = [out.sat_vcd, out.sat_error, out.ctm_vcd, out.aux1, out.aux2]
    dt = fields[0].dtype
    scal = jnp.zeros((0,), dt)
    if with_oi:
        fields += [out.oi.xb, out.oi.averaging_kernel, out.oi.increment,
                   out.oi.error]
        scal = jnp.stack([jnp.asarray(out.oi.reg_factor, dt)]
                         + [jnp.asarray(v, dt) for v in out.innovation])
    hw = fields[0].shape
    pad = jnp.full((hw[0] * hw[1],), jnp.nan, dt)
    pad = pad.at[: scal.size].set(scal).reshape(hw)
    return jnp.stack(fields + [pad])


_pack_month_pull = jax.jit(_pack_month_pull, static_argnames=("with_oi",))


def _desroziers_step(xa, y_clip, xb, sa_var, so_var, bins, nb):
    """One Desroziers (re-)estimation pass: (sa_step, so_step) scale
    factors — scalars for the global estimator, per-cell maps for the
    binned one.  Shared by the scalar and full-covariance OI branches."""
    from oisat.ops.diagnostics import desroziers_binned, desroziers_estimates

    args = tuple(jnp.asarray(v) for v in (xa, y_clip, xb, sa_var, so_var))
    if bins is None:
        est = desroziers_estimates(*args)
        return float(est.sa_scale), float(est.so_scale)
    est = desroziers_binned(*args, bins, nb)

    def bcast(scale):
        # label -1 = "no band" (non-finite coordinates): those cells keep
        # scale 1 instead of indexing out of range
        b = np.asarray(bins)
        safe = np.clip(b, 0, nb - 1)
        return np.where(b >= 0, np.asarray(scale, np.float64)[safe], 1.0)

    return bcast(est.sa_scale), bcast(est.so_scale)


def _desroziers_diag(nb, bins, sa_total, so_total, iterations):
    """The oi_diagnostics entries for a Desroziers sweep (+ per-bin scale
    spread when binned)."""
    d = {"desroziers_sa_scale": float(np.nanmean(sa_total)),
         "desroziers_so_scale": float(np.nanmean(so_total)),
         "desroziers_iterations": int(iterations)}
    if bins is not None:
        d.update({
            "desroziers_bins": nb,
            "desroziers_sa_scale_min": float(np.nanmin(sa_total)),
            "desroziers_sa_scale_max": float(np.nanmax(sa_total)),
            "desroziers_so_scale_min": float(np.nanmin(so_total)),
            "desroziers_so_scale_max": float(np.nanmax(so_total))})
    return d


class oisatgmi:
    """One analysis session (one sensor, one gas, one month)."""

    def __init__(self) -> None:
        pass

    # -- ingestion (reference driver.py:22-34) ------------------------------
    def read_data(self, ctm_type: str, ctm_path: Path, ctm_gas_name: str,
                  ctm_frequency: str, sat_type: str, sat_path: Path, YYYYMM: str,
                  averaging=False, read_ak=True, trop=False, num_job=1,
                  mcip_dir=None, tempo_hour=None, control_free="control_free.yml"):
        from oisat.readers import readers

        # the reference job runner passes read_AK as the *string* "False"
        # for FREE runs (reference run/job.py:21-23) and compares with
        # `== True` downstream; normalize to a real bool here.
        if isinstance(read_ak, str):
            read_ak = read_ak.lower() == "true"
        reader_obj = readers()
        reader_obj.add_ctm_data(ctm_type, Path(ctm_path), mcip_dir=mcip_dir)
        with stage("read_ctm"):
            reader_obj.read_ctm_data(YYYYMM, ctm_gas_name, frequency_opt=ctm_frequency,
                                     averaging=averaging, num_job=num_job,
                                     control_free=control_free)
        reader_obj.add_satellite_data(sat_type, Path(sat_path))
        with stage("read_satellite"):
            reader_obj.read_satellite_data(YYYYMM, read_ak=read_ak, trop=trop,
                                           num_job=num_job, tempo_hour=tempo_hour)
        self.reader_obj = reader_obj
        self.gasname = ctm_gas_name[0]

    # -- observation operators (reference driver.py:36-51) ------------------
    def recal_amf(self):
        with stage("amf_recal"):
            self.reader_obj.sat_data = amf_recal(self.reader_obj.ctm_data, self.reader_obj.sat_data)

    def cal_pwv(self):
        with stage("pwv"):
            self.reader_obj.sat_data = pwv_calculator(self.reader_obj.ctm_data, self.reader_obj.sat_data)

    def conv_ak(self, sensor: str):
        with stage("ak_conv"):
            if sensor == "MOPITT":
                self.reader_obj.sat_data = ak_conv_mopitt(self.reader_obj.ctm_data, self.reader_obj.sat_data)
            if sensor == "GOSAT":
                self.reader_obj.sat_data = ak_conv_gosat(self.reader_obj.ctm_data, self.reader_obj.sat_data)

    # -- analysis (reference driver.py:53-114) -------------------------------
    def average(self, startdate: str, enddate: str, gasname=None, weighting=None):
        """Monthly averaging.  ``weighting`` (extension; default None =
        reference parity): "inverse_variance" weights granules by 1/sigma^2,
        "ak" by averaging-kernel information content (opt sensors)."""
        with stage("average"):
            self._average_impl(startdate, enddate, gasname, weighting)

    def _average_impl(self, startdate, enddate, gasname, weighting=None):
        (self.sat_averaged_vcd, self.sat_averaged_error, self.ctm_averaged_vcd,
         self.aux1, self.aux2, self.avg_time) = averaging(startdate, enddate,
                                                          self.reader_obj,
                                                          weighting=weighting)
        if gasname == "O3":
            # CTM O3 column to DU (reference driver.py:62-63)
            self.ctm_averaged_vcd = self.ctm_averaged_vcd / (2.69e16 * 1e-15)

    def bias_correct(self, sat_type, gasname):
        key = (sat_type, gasname)
        if key in BIAS_CORRECTIONS:
            print(f"applying the bias correction for {sat_type} {gasname}")
            offset, slope = BIAS_CORRECTIONS[key]
            self.sat_averaged_vcd = (self.sat_averaged_vcd - offset) / slope
        else:
            print("NOT applying the bias correction for satellite VCDs")

    def oi(self, sensor: str, error_ctm=50.0, method="scalar", length_scale_km=300.0,
           desroziers_iterations=0, desroziers_bins=1, mesh=None):
        """The analysis update.

        ``method="scalar"`` (default) is the reference's per-cell diagonal
        update with the 99-factor regularization scan; ``method="full"``
        uses the distance-decay background covariance and the blocked-
        Cholesky Kalman solve (:mod:`oisat.ops.oi_full`) so one
        observation updates its spatial neighbourhood.

        ``desroziers_iterations`` (extension): re-estimate the So/Sa error
        variances from the innovation/residual cross-moments (Desroziers
        2005) and re-run the update that many times; the diagnosed scales
        land in ``oi_diagnostics``.  The total innovation variance is
        matched exactly (chi^2 -> 1); with one global bin the Sa/So *split*
        inherits the first-pass gain, the known identifiability limit of
        the scalar diagonal case.  ``desroziers_bins`` > 1 estimates the
        scales per latitude band instead, breaking that degeneracy when the
        true errors vary spatially (the per-bin scale range lands in
        ``oi_diagnostics``).
        """
        with stage("oi"):
            self._oi_impl(sensor, error_ctm, method, length_scale_km,
                          desroziers_iterations, desroziers_bins, mesh=mesh)

    def _oi_impl(self, sensor, error_ctm, method="scalar", length_scale_km=300.0,
                 desroziers_iterations=0, desroziers_bins=1, mesh=None):
        # never leak a previous run's binned scale maps from this object
        self.desroziers_sa_scale_map = None
        self.desroziers_so_scale_map = None
        if sensor != "GOSAT":
            xa, y = self.ctm_averaged_vcd, self.sat_averaged_vcd
        else:
            # GOSAT assimilates the xcol pair instead of VCD (reference driver.py:112-114)
            xa, y = self.aux2, self.aux1
        if method == "full":
            from oisat.ops.oi_full import oi_full

            idx = self._first_valid()
            sat = self.reader_obj.sat_data[idx]
            sigma_b = np.asarray(xa) * error_ctm / 100.0
            sigma_o = np.asarray(self.sat_averaged_error)
            res = oi_full(xa, y, sigma_b, sigma_o, sat.latitude_center,
                          sat.longitude_center, length_scale_km,
                          regularization_on=True, mesh=mesh)
            sa_scale_total, so_scale_total = 1.0, 1.0
            # moments must see the innovation the solver assimilated:
            # oi_full clips negative observations to 0 (reference
            # optimal_interpolation.py:14)
            y_clip = np.where(np.asarray(y, np.float64) < 0, 0.0,
                              np.asarray(y, np.float64))
            nb = int(desroziers_bins)
            bins = None
            if nb > 1:
                from oisat.ops.diagnostics import lat_band_index

                bins = lat_band_index(sat.latitude_center, nb)
                sa_scale_total = np.ones_like(np.asarray(xa, np.float64))
                so_scale_total = np.ones_like(sa_scale_total)
            for _ in range(int(desroziers_iterations)):
                # Desroziers moments are gain-agnostic: rescale the error
                # std-devs and re-solve with the full covariance
                sa_step, so_step = _desroziers_step(
                    np.asarray(xa, np.float64), y_clip,
                    np.asarray(res.xb, np.float64),
                    sigma_b.astype(np.float64) ** 2,
                    sigma_o.astype(np.float64) ** 2, bins, nb)
                sigma_b = sigma_b * np.sqrt(sa_step)
                sigma_o = sigma_o * np.sqrt(so_step)
                sa_scale_total = sa_scale_total * sa_step
                so_scale_total = so_scale_total * so_step
                res = oi_full(xa, y, sigma_b, sigma_o, sat.latitude_center,
                              sat.longitude_center, length_scale_km,
                              regularization_on=True, mesh=mesh)
            self.ctm_averaged_vcd_corrected = res.xb
            self.ak_OI = res.averaging_kernel
            self.increment_OI = res.increment
            self.error_OI = res.error
            # always (re)write diagnostics: a stale dict from a previous
            # run on this object must not leak into the diag file.  The
            # same observation-space consistency stats as the scalar
            # method (sa here is the diagonal of the solver's B), merged
            # with the solver's own info (CG iterations on the
            # matrix-free path)
            from oisat.ops.diagnostics import innovation_stats

            st = innovation_stats(
                jnp.asarray(np.asarray(xa, np.float64)),
                jnp.asarray(y_clip), jnp.asarray(np.asarray(res.xb, np.float64)),
                jnp.asarray(sigma_b.astype(np.float64) ** 2),
                jnp.asarray(sigma_o.astype(np.float64) ** 2))
            self.oi_diagnostics = {k: float(v) for k, v in st._asdict().items()}
            # h5py cannot store None attrs (f64_resid/resid_abs are None
            # when no f64 verification ran) — drop them from the diag dict
            self.oi_diagnostics.update(
                {k: v for k, v in (res.info or {}).items() if v is not None})
            if desroziers_iterations:
                self.oi_diagnostics.update(_desroziers_diag(
                    nb, bins, sa_scale_total, so_scale_total,
                    desroziers_iterations))
                if bins is not None:
                    self.desroziers_sa_scale_map = sa_scale_total
                    self.desroziers_so_scale_map = so_scale_total
            return
        sa = (np.asarray(xa) * error_ctm / 100.0) ** 2
        so = np.asarray(self.sat_averaged_error) ** 2
        res = oi_op(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa), jnp.asarray(so),
                    regularization_on=True)
        desroziers = None
        if desroziers_iterations:
            from oisat.ops.diagnostics import lat_band_index

            nb = int(desroziers_bins)
            bins = None
            if nb > 1:
                lat = self.reader_obj.sat_data[self._first_valid()].latitude_center
                bins = lat_band_index(lat, nb)
            # scale maps start as 1 (global: scalars; binned: per-cell maps)
            sa_scale_total = np.ones(()) if bins is None else np.ones_like(np.asarray(xa, np.float64))
            so_scale_total = np.ones_like(sa_scale_total)
            # moments must see the innovation the solver assimilated (the
            # OI clips negative observations to 0)
            y_clip = np.where(np.asarray(y, np.float64) < 0, 0.0,
                              np.asarray(y, np.float64))
            for _ in range(int(desroziers_iterations)):
                sa_step, so_step = _desroziers_step(xa, y_clip, res.xb, sa, so,
                                                    bins, nb)
                sa = sa * sa_step
                so = so * so_step
                sa_scale_total = sa_scale_total * sa_step
                so_scale_total = so_scale_total * so_step
                res = oi_op(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(sa),
                            jnp.asarray(so), regularization_on=True)
            desroziers = _desroziers_diag(nb, bins, sa_scale_total,
                                          so_scale_total, desroziers_iterations)
            if bins is not None:
                self.desroziers_sa_scale_map = sa_scale_total
                self.desroziers_so_scale_map = so_scale_total
            print(f"Desroziers re-estimation ({nb} bin(s)): "
                  f"Sa x{float(np.nanmean(sa_scale_total)):.3g}, "
                  f"So x{float(np.nanmean(so_scale_total)):.3g}")
        self.reg_factor = float(res.reg_factor)
        print("The regularization factor is " + str(self.reg_factor))
        self.ctm_averaged_vcd_corrected = np.asarray(res.xb)
        self.ak_OI = np.asarray(res.averaging_kernel)
        self.increment_OI = np.asarray(res.increment)
        self.error_OI = np.asarray(res.error)
        # observation-space consistency diagnostics (extension), on the
        # y<0 -> 0 clamped observation the OI assimilated — the same
        # convention as the Desroziers moments above, the oi_method="full"
        # branch, and the fused program's in-step fold
        from oisat.ops.diagnostics import innovation_stats

        y_stats = np.where(np.asarray(y, np.float64) < 0, 0.0,
                           np.asarray(y, np.float64))
        st = innovation_stats(jnp.asarray(xa), jnp.asarray(y_stats),
                              jnp.asarray(self.ctm_averaged_vcd_corrected),
                              jnp.asarray(sa), jnp.asarray(so))
        self.oi_diagnostics = {k: float(v) for k, v in st._asdict().items()}
        if desroziers:
            self.oi_diagnostics.update(desroziers)
        print("OI diagnostics: "
              f"n={int(st.n)} OmB={float(st.omb_mean):+.3g}/{float(st.omb_rms):.3g} "
              f"OmA={float(st.oma_mean):+.3g}/{float(st.oma_rms):.3g} "
              f"chi2={float(st.chi2):.3g}")

    # -- fused on-device month analysis (the parallel/ path in production) ---
    def analyze_month_fused(self, sensor: str, gasname: str, startdate: str,
                            enddate: str, error_ctm=50.0, mesh=None,
                            weighting=None, save_daily=None,
                            oi_method="scalar", length_scale_km=300.0,
                            desroziers_iterations=0, desroziers_bins=1):
        """Run the WHOLE month analysis as one jitted device program:
        the vmapped observation operator over the granule stack + monthly
        statistics + bias correction + OI — the
        :mod:`oisat.parallel.analysis` month steps, wired into the
        production driver.  Replaces ``recal_amf/conv_ak/cal_pwv ->
        average -> bias_correct -> oi`` for months whose granules share
        one kind and shape: satellite_amf (AMF recal), MOPITT/GOSAT
        (AK convolution; GOSAT assimilates the xcol pair) and SSMIS
        (PWV).  Under a multi-device ``mesh`` the granule batch shards
        over 'obs' and grid rows over 'grid' (single-chip: a 1x1 mesh);
        non-mesh-divisible months are NaN-padded automatically.  O3 months
        apply the DU conversion in-program (ctm_scale) and upscaled-CTM
        months upscale the matched CTM slices through the cached plans.
        Raises ValueError when the month is not fusable (no scattering
        weights, mixed kinds or shapes, no granules) — callers fall back
        to the staged pipeline.

        The pipeline extensions COMPOSE with the fused program
        (VERDICT r3 item 4):

        - ``weighting``: the weighted temporal mean runs in-program
          (weights computed on device from the granule stack with the
          exact ``ops.averaging._granule_weights`` formulas);
        - ``save_daily=(folder, datestr)``: the per-granule operator
          outputs come back in ONE batched D2H pull and are written as
          the standard ``sat_data_*.mat`` files (reference
          driver.py:127-146);
        - ``desroziers_iterations`` / ``oi_method="full"`` /
          ``length_scale_km``: the averaged fields come from the fused
          program and the OI tail re-runs host-side through
          :meth:`oi`'s machinery (Desroziers re-estimation, or the
          full-covariance blocked-Cholesky solve of
          :mod:`oisat.ops.oi_full`).

        Return contract: the driver attributes (``self.sat_averaged_vcd``
        … ``self.ctm_averaged_vcd_corrected``, ``self.oi_diagnostics``)
        always carry the final results (the scaling factor itself is
        derived from them inside :meth:`write_to_nc`, never stored on the
        driver).  The returned :class:`AnalysisOutputs` mirrors
        them EXCEPT on the host-tail months above (``oi_method="full"``
        or Desroziers), where the in-program OI stage is skipped as dead
        compute: there ``out.oi`` holds NaN placeholders (``reg_index``
        -1) and ``out.scaling_factor`` is all ones — read the driver
        attributes, not the return value, for OI results.
        """
        import datetime

        from oisat.datamodel import satellite_amf, satellite_opt, satellite_ssmis
        from oisat.parallel.mesh import make_mesh

        with stage("fused_month"):
            ctm_data = self.reader_obj.ctm_data
            start = datetime.date(int(startdate[0:4]), int(startdate[5:7]),
                                  int(startdate[8:10]))
            end = datetime.date(int(enddate[0:4]), int(enddate[5:7]),
                                int(enddate[8:10]))
            # keep each granule's position in sat_data: save_daily names
            # its files by that counter, exactly like the staged walk
            pairs = [(i, g) for i, g in enumerate(self.reader_obj.sat_data)
                     if g is not None and start <= g.time.date() < end]
            # device-granule months defer the off-domain check (regridder
            # device mode); settle ALL the validity scalars with one pull
            dv = [getattr(g, "_device_valid", None) for _, g in pairs]
            pairs = [p for p, ok in zip(pairs, _settled_valid(dv)) if ok]
            grans = [g for _, g in pairs]
            if not grans:
                raise ValueError("no valid satellite granules to fuse")
            # CTM O3 columns convert to DU between averaging and OI in the
            # staged pipeline (reference driver.py:62-63); the fused program
            # applies the same scale through analysis_step's ctm_scale hook
            ctm_scale = 1.0 / (2.69e16 * 1e-15) if gasname == "O3" else 1.0

            kinds = {satellite_amf: "amf", satellite_opt: "opt",
                     satellite_ssmis: "ssmis"}
            kind = kinds.get(type(grans[0]))
            if kind is None or not all(type(g) is type(grans[0]) for g in grans):
                raise ValueError("fused month path needs one granule kind")
            if kind == "amf":
                if any(np.size(g.scattering_weights) == 1 for g in grans):
                    raise ValueError("fused month path needs scattering weights")
                shapes = {(np.shape(g.vcd), np.shape(g.pressure_mid)) for g in grans}
            else:
                shapes = {np.shape(g.vcd) for g in grans}
            if len(shapes) != 1:
                raise ValueError(f"fused month path needs one granule shape, got {shapes}")

            if weighting == "ak" and kind != "opt":
                # same contract as the staged _granule_weights: AK
                # information-content weights need averaging-kernel
                # granules (MOPITT/GOSAT)
                raise ValueError("weighting='ak' needs averaging-kernel "
                                 "granules (MOPITT/GOSAT); use "
                                 "'inverse_variance' otherwise")
            offset, slope = BIAS_CORRECTIONS.get((sensor, gasname), (0.0, 1.0))
            if (sensor, gasname) in BIAS_CORRECTIONS:
                print(f"applying the bias correction for {sensor} {gasname}")
            if mesh is None:
                mesh = make_mesh(1)
            inputs, maker = self._fused_inputs(kind, sensor, ctm_data, grans)
            # full-covariance / Desroziers months re-run the OI tail
            # host-side below: skip the in-program OI stage (its 99-factor
            # curve scan dominates the analysis compute) instead of
            # computing a result only to discard it
            host_oi_tail = oi_method == "full" or int(desroziers_iterations) > 0
            fn, shard = maker(mesh, bias_offset=offset, bias_slope=slope,
                              error_ctm=float(error_ctm),
                              ctm_scale=float(ctm_scale),
                              weighting=weighting,
                              return_granules=save_daily is not None,
                              run_oi=not host_oi_tail)
            out = fn(shard(inputs))
            if save_daily is not None:
                out, daily = out
                self._write_daily_mats(save_daily[0], gasname, pairs, daily)

            # ONE batched D2H pull for every host-bound result (fields +
            # the reg-factor/innovation scalars) — see _pack_month_pull
            packed = np.asarray(_pack_month_pull(out, not host_oi_tail),
                                np.float64)
            # per-plane copies: view-unpacking would pin the whole packed
            # base (including the ~33 MB NaN scalar-pad plane at the
            # production grid) in memory for the attributes' lifetime
            (self.sat_averaged_vcd, self.sat_averaged_error,
             self.ctm_averaged_vcd, self.aux1, self.aux2) = (
                p.copy() for p in packed[:5])
            avg_ts = sum(g.time.timestamp() for g in grans) / len(grans)
            self.avg_time = datetime.datetime.fromtimestamp(avg_ts)
            if host_oi_tail:
                # the averaged fields come from the fused program; the OI
                # tail re-runs host-side through the staged machinery (the
                # full-covariance solve and Desroziers re-estimation are
                # iterative host-driven loops, not a fixed device graph) —
                # it overwrites the in-program OI result and writes its own
                # diagnostics
                self._oi_impl(sensor, error_ctm, oi_method, length_scale_km,
                              desroziers_iterations, desroziers_bins,
                              mesh=mesh)  # 1-device meshes are dropped by
                # the consumer (oi_full_matfree)
                return out
            (self.ctm_averaged_vcd_corrected, self.ak_OI,
             self.increment_OI, self.error_OI) = (
                p.copy() for p in packed[5:9])
            scal = packed[-1].ravel().copy()
            self.reg_factor = float(scal[0])
            print("The regularization factor is " + str(self.reg_factor))
            # innovation/chi2 diagnostics computed IN the fused program
            # (analysis_step folds them over the same xa/y pair the OI
            # assimilated — GOSAT's xcol swap and the y<0 clamp included);
            # they ride the same batched pull (scalar plane order:
            # reg_factor, then the innovation NamedTuple fields)
            names = type(out.innovation)._fields
            self.oi_diagnostics = {k: float(v)
                                   for k, v in zip(names, scal[1:1 + len(names)])}
            return out

    def _daily_latlon(self):
        """CTM lat/lon for the daily files.  Preserved reference hazard
        (reference driver.py:140-142): the first-valid *satellite* index
        addresses the CTM list; if the first ``len(ctm_data)`` granules of
        the month are all None this raises IndexError, exactly like the
        reference."""
        idx = self._first_valid()
        c = self.reader_obj.ctm_data[idx]
        return c.latitude, c.longitude

    @staticmethod
    def _write_daily_mat(folder, gasname, counter, when, vcd, ctm_vcd, err,
                         lat, lon):
        """ONE reference-format daily file (reference driver.py:127-146):
        the timestamp formula, the ``sat_data_{gas}_{t}{counter}.mat`` name
        and the payload keys — shared by the staged :meth:`savedaily` walk
        and the fused batched pull so the two paths cannot drift."""
        from scipy.io import savemat

        t = (10000.0 * when.year + 100.0 * when.month + when.day
             + when.hour / 24.0)
        savemat(os.path.join(folder, f"sat_data_{gasname}_{t}{counter}.mat"),
                {"vcd_sat": vcd, "vcd_ctm": ctm_vcd, "vcd_err": err,
                 "time_sat": t, "lat": lat, "lon": lon})

    def _write_daily_mats(self, folder, gasname, pairs, daily):
        """Write the per-granule ``sat_data_*.mat`` daily files from the
        fused program's batched :class:`DailyGranules` pull — same content
        and counter-based naming as :meth:`savedaily` (reference
        driver.py:127-146), one D2H transfer for the whole month."""
        os.makedirs(folder, exist_ok=True)
        n = len(pairs)
        # ONE pull per field; NaN-padded mesh granules trail and are cut
        vcd = np.asarray(daily.vcd, np.float64)[:n]
        ctm = np.asarray(daily.ctm_vcd, np.float64)[:n]
        err = np.asarray(daily.uncertainty, np.float64)[:n]
        latitude, longitude = (np.asarray(a) for a in self._daily_latlon())
        for (counter, g), v, c, e in zip(pairs, vcd, ctm, err):
            self._write_daily_mat(folder, gasname, counter, g.time, v, c, e,
                                  latitude, longitude)

    def _fused_inputs(self, kind: str, sensor: str, ctm_data, grans):
        """Assemble the (stacked inputs, step maker) for one granule kind —
        the same per-granule CTM matching/slicing as the staged operators
        (obs_operators), batched for the fused device program."""
        from oisat.obs_operators import (
            _amf_one,
            _ctm_times,
            _daily_ctm_slice,
            _match_daily,
            _maybe_upscale,
        )
        from oisat.ops.vertical import GRAV, MAIR, N_A
        from oisat.parallel.analysis import (
            FullMonthEtaInputs,
            FullMonthInputs,
            GosatMonthInputs,
            MopittMonthInputs,
            SsmisMonthInputs,
            make_full_month_eta_step,
            make_full_month_step,
            make_gosat_month_step,
            make_mopitt_month_step,
            make_ssmis_month_step,
        )

        from oisat.regridder import f16_transfer_default, fits_f16

        f32 = np.float32
        narrow = f16_transfer_default()

        def stack(arrs):
            if arrs and all(isinstance(a, jax.Array) for a in arrs):
                # device granules: stacked in place by ONE jitted program
                # for the whole month (_settle_stacks), nothing to transfer
                return _DeferredStack(arrs)
            out = np.stack([np.asarray(a) for a in arrs])
            # f64 sources keep full precision ONLY in full-precision mode
            # (parity / OISAT_F16_TRANSFER=0); in production narrow mode
            # they take the f32 transfer dtype like the staged _stack16 —
            # otherwise host f64 intermediates (matched CTM slices, the
            # NaN pad slice's dtype promotion) dodge the f16 narrowing
            # below and ship twice the bytes
            if out.dtype == np.float64 and not narrow:
                return out
            return out.astype(f32) if out.dtype != f32 else out

        def stack_lv(arrs):
            # per-level stacks take the narrow transfer dtype, like the
            # staged operators (obs_operators._stack16): f32 AND f64
            # sources -> f16 in narrow mode (full precision is the parity
            # switches' contract, not the source dtype's); fields beyond
            # f16 range (OMPS column-as-pressure, MOPITT air columns)
            # keep f32.  Device leaves stack in place — narrowing would
            # only cost.
            out = stack(arrs)
            if (narrow and isinstance(out, np.ndarray)
                    and out.dtype == f32 and fits_f16(out)):
                return out.astype(np.float16)
            return out

        time_ctm, time_hour = _ctm_times(ctm_data)

        if kind == "amf":
            from oisat.obs_operators import _affine_group, _ctm_slice_key
            from oisat.parallel.analysis import dedup_first_seen
            from oisat.regridder import parity_mode

            pmids, pcs, trops, keys = [], [], [], []
            for g in grans:
                closest, pmid, pc, trop, _has = _amf_one(ctm_data, g, time_ctm,
                                                         time_hour)
                pmids.append(pmid)
                pcs.append(pc)
                # no-tropopause granules pass zeros: pmid < 0 never holds,
                # reproducing the has_trop=False branch
                trops.append(trop)
                keys.append(_ctm_slice_key(g, closest))
            slice_order, idxs = dedup_first_seen(keys)

            if parity_mode():
                # parity keeps the reference's full per-level transfer
                carriers = None
            elif any(isinstance(g.vcd, jax.Array) for g in grans):
                # device granules carry their carrier + tables from the
                # regrid (detecting afresh would pull every stack back)
                tabs = [getattr(g, "_pmid_ab", None) for g in grans]
                carriers = ([g._pmid_carrier for g in grans]
                            if all(t is not None for t in tabs) else None)
            else:
                grp = _affine_group([np.asarray(g.pressure_mid)
                                     for g in grans])
                if grp is not None:
                    carriers, a_list, b_list = grp
                    tabs = list(zip(a_list, b_list))
                else:
                    carriers = None
            if carriers is not None:
                # transfer-compressed month: pmid carrier + tables, and one
                # copy of each distinct CTM slice (+ a trailing NaN slice
                # for mesh padding) gathered on device
                nan_pmid = np.full(np.asarray(pmids[0]).shape, np.nan,
                                   dtype=np.asarray(pmids[0]).dtype)
                u_pmids = [pmids[i] for i in slice_order] + [nan_pmid]
                u_pcs = [pcs[i] for i in slice_order] + [nan_pmid]
                # CTM-side carrier compression (independent of the
                # sat-side tables above): GMI/ECCOH pressure stacks are
                # hybrid-eta affine too, so ship ONE carrier level + a
                # (U+1, Lc) table pair per unique slice instead of the
                # full (U+1, Lc, H, W) stack — the CTM slices are the
                # dominant analysis-leg H2D of a device-granule month.
                # CMAQ's MCIP 3-D pressures fail the fit and keep the
                # full stack (the (1, 1) dummy tables flag it)
                cgrp = _affine_group([np.asarray(pmids[i])
                                      for i in slice_order])
                if cgrp is not None:
                    c_carr, c_a, c_b = cgrp
                    nan_hw = np.full(np.asarray(pmids[0]).shape[-2:],
                                     np.nan, np.float32)
                    ctm_pm_in = stack_lv(list(c_carr) + [nan_hw])[:, None]
                    nan_tab = np.full(np.asarray(pmids[0]).shape[0], np.nan)
                    ctm_a = stack(list(c_a) + [nan_tab])
                    ctm_b = stack(list(c_b) + [nan_tab])
                else:
                    ctm_pm_in = stack_lv(u_pmids)
                    ctm_a = ctm_b = np.zeros((1, 1), np.float32)
                return _settle_stacks(FullMonthEtaInputs(
                    sat_pmid_carrier=stack_lv(carriers),
                    sat_pmid_a=stack([t[0] for t in tabs]),
                    sat_pmid_b=stack([t[1] for t in tabs]),
                    sat_sw=stack_lv([g.scattering_weights for g in grans]),
                    vcd=stack([g.vcd for g in grans]),
                    amf=stack([g.amf for g in grans]),
                    uncertainty=stack([g.uncertainty for g in grans]),
                    tropopause=stack(trops),
                    ctm_pmid=ctm_pm_in,
                    ctm_pc=stack_lv(u_pcs),
                    ctm_idx=np.asarray(idxs, np.int32),
                    ctm_pmid_a=ctm_a, ctm_pmid_b=ctm_b,
                )), make_full_month_eta_step
            return _settle_stacks(FullMonthInputs(
                sat_pmid=stack_lv([g.pressure_mid for g in grans]),
                sat_sw=stack_lv([g.scattering_weights for g in grans]),
                vcd=stack([g.vcd for g in grans]),
                amf=stack([g.amf for g in grans]),
                uncertainty=stack([g.uncertainty for g in grans]),
                tropopause=stack(trops),
                ctm_pmid=stack_lv(pmids),
                ctm_pc=stack_lv(pcs),
            )), make_full_month_step

        if kind == "ssmis":
            pcw = []
            for g in grans:
                _, day = _match_daily(g.time, ctm_data, time_ctm)
                c = ctm_data[day]
                if c.ctmtype in ("ECCOH", "FREE"):
                    dp, q = np.squeeze(c.delta_p), np.squeeze(c.gas_profile)
                else:
                    dp = np.squeeze(np.nanmean(c.delta_p, axis=0))
                    q = np.squeeze(np.nanmean(c.gas_profile, axis=0))
                pc = dp * q / 9.80665 / 10000.0
                if g.ctm_upscaled_needed:
                    (pc,) = _maybe_upscale(ctm_data, g, [pc])
                pcw.append(pc)
            return _settle_stacks(SsmisMonthInputs(
                water_pc=stack_lv(pcw),
                vcd=stack([g.vcd for g in grans]),
                uncertainty=stack([g.uncertainty for g in grans]),
            )), make_ssmis_month_step

        # opt sensors: MOPITT (vcd OI) vs GOSAT (xcol-pair OI)
        from oisat.obs_operators import (_affine_group,
                                             _carrier_tables_group)

        pmids, profs, airpcs = [], [], []
        airpc_scale = 1.0 / GRAV / MAIR * N_A * 1e-4 * 1e-15 * 100.0
        for g in grans:
            _, day = _match_daily(g.time, ctm_data, time_ctm)
            pmid, prof, dp = _daily_ctm_slice(ctm_data, day)
            # host NumPy (no per-granule device dispatch)
            airpc = np.asarray(dp, np.float64) * airpc_scale
            if g.ctm_upscaled_needed:
                # upscale the matched CTM slices onto the (finer) granule
                # grid, like the staged operators (obs_operators)
                pmid, prof, airpc = _maybe_upscale(ctm_data, g,
                                                   [pmid, prof, airpc])
            pmids.append(np.asarray(pmid))
            profs.append(prof)
            airpcs.append(airpc)
        # carrier-compress the CTM pressure stacks (and, for MOPITT, the
        # air-column stacks against the SAME carrier — both are affine in
        # surface pressure for GMI/ECCOH).  One layout per month: any
        # granule failing the fit keeps the whole month full
        # (obs_operators._affine_group, shared with the staged batches).
        comp = _affine_group(pmids)
        if comp is not None:
            carriers, pm_as, pm_bs = comp
            # carrier at f32, NOT the f16 stack_lv dtype: MOPITT's air
            # columns reconstruct from this carrier with slopes ~1e6, so
            # f16's ~0.5 hPa rounding would inject ~5e-4 relative error
            # into a stack the staged path ships at f32 (the 'NEVER f16'
            # air-column rule).  One level at f32 is still Lc/2x smaller
            # than the f16 full stack it replaces.
            ctm_pm_in = stack([c[None] for c in carriers])
            pm_a = stack(pm_as)
            pm_b = stack(pm_bs)
        else:
            ctm_pm_in = stack_lv(pmids)
            pm_a = pm_b = np.zeros((1, 1), np.float32)
        if sensor == "GOSAT":
            # GOSAT ships its per-level stacks at f32, NOT the f16 narrow
            # dtype: the reference stores AKs / pressure weights / apriori
            # profiles / pressures at FULL precision (reference reader.py
            # GOSAT section — no astype('float16') anywhere), and the
            # xcol-pair innovations are ~10 ppb anomalies on a ~1900 ppb
            # background, so f16's 1.0 ppb spacing would inject
            # percent-level innovation errors the reference never has.
            return _settle_stacks(GosatMonthInputs(
                ctm_pmid=ctm_pm_in,
                ctm_profile=stack(profs),
                ctm_pmid_a=pm_a, ctm_pmid_b=pm_b,
                sat_pmid=stack([g.pressure_mid for g in grans]),
                aks=stack([g.averaging_kernels for g in grans]),
                apriori_profile=stack([g.apriori_profile for g in grans]),
                pressure_weight=stack([g.pressure_weight for g in grans]),
                vcd=stack([g.vcd for g in grans]),
                x_col=stack([g.x_col for g in grans]),
                uncertainty=stack([g.uncertainty for g in grans]),
            )), make_gosat_month_step
        airpc_tabs = (_carrier_tables_group(airpcs, carriers)
                      if comp is not None else None)
        if airpc_tabs is not None:
            hc, wc = pmids[0].shape[-2:]
            # the stack reconstructs on device from the pressure carrier;
            # ship only the empty placeholder + (G, Lc) tables (f32 —
            # air columns are ~1e9 per layer, and stack() never narrows
            # below f32)
            airpc_in = np.zeros((len(grans), 0, hc, wc), np.float32)
            ai_a = stack(airpc_tabs[0])
            ai_b = stack(airpc_tabs[1])
        else:
            # (a carrier pmid with a full airpc is fine — the step's two
            # shape branches are independent.)  NEVER f16: air partial
            # columns are ~1e9 per layer, beyond f16 range (stack_lv's
            # fits_f16 guard would also catch this)
            airpc_in = stack(airpcs)
            ai_a = ai_b = np.zeros((1, 1), np.float32)
        return _settle_stacks(MopittMonthInputs(
            ctm_pmid=ctm_pm_in,
            ctm_profile=stack_lv(profs),
            ctm_airpc=airpc_in,
            ctm_pmid_a=pm_a, ctm_pmid_b=pm_b,
            ctm_airpc_a=ai_a, ctm_airpc_b=ai_b,
            sat_pmid=stack_lv([g.pressure_mid for g in grans]),
            aks=stack_lv([g.averaging_kernels for g in grans]),
            # the reference keeps MOPITT's apriori profile full-precision
            # (unlike its f16 AKs/pressures) — ship it wide
            apriori_profile=stack([g.apriori_profile for g in grans]),
            aprior_col=stack([g.aprior_column for g in grans]),
            apriori_surface=stack([g.apriori_surface for g in grans]),
            vcd=stack([g.vcd for g in grans]),
            x_col=stack([g.x_col for g in grans]),
            uncertainty=stack([g.uncertainty for g in grans]),
        )), make_mopitt_month_step

    def settle_device_granules(self):
        """Apply the deferred off-domain check of device-granule mode:
        granules whose ``_device_valid`` scalar is False become None,
        giving the staged pipeline the same granule list host mode
        produces (reference interpolator.py:165-167 drops them at regrid).
        One batched pull for all the validity scalars; no-op when no
        granule carries one."""
        sat = self.reader_obj.sat_data
        dv = [getattr(g, "_device_valid", None) if g is not None else None
              for g in sat]
        if not any(v is not None for v in dv):
            return
        self.reader_obj.sat_data = [
            g if ok else None for g, ok in zip(sat, _settled_valid(dv))]

    # -- stage-boundary checkpointing (extension; SURVEY.md §5) --------------
    def save_state(self, path):
        """Persist the processed granule list; ``average → oi →
        write_to_nc`` can later resume from it without re-reading L2."""
        from oisat.utils.granule_store import save_granules

        # device-granule months defer the off-domain check to a
        # _device_valid scalar that save_granules would drop: apply it
        # now so a checkpoint never resurrects a granule host mode
        # rejects at regrid (reference interpolator.py:165-167)
        self.settle_device_granules()
        save_granules(path, self.reader_obj.sat_data)

    def load_state(self, path, ctm_data=None):
        """Resume from a granule checkpoint (inverse of save_state)."""
        from types import SimpleNamespace

        from oisat.utils.granule_store import load_granules

        sat = load_granules(path)
        if getattr(self, "reader_obj", None) is None:
            self.reader_obj = SimpleNamespace(ctm_data=ctm_data or [], sat_data=sat)
        else:
            self.reader_obj.sat_data = sat

    # -- outputs (reference driver.py:115-227) --------------------------------
    def _first_valid(self):
        return next(i for i, s in enumerate(self.reader_obj.sat_data) if s is not None)

    def reporting(self, fname: str, gasname, folder="report"):
        from oisat.report import report

        idx = self._first_valid()
        sat = self.reader_obj.sat_data[idx]
        ctm = self.reader_obj.ctm_data[0]
        # plot on the coarser of the two grids (reference driver.py:119-129)
        if np.size(ctm.latitude) * np.size(ctm.longitude) < \
           np.size(sat.latitude_center) * np.size(sat.longitude_center):
            lat, lon = sat.latitude_center, sat.longitude_center
        else:
            lat, lon = ctm.latitude, ctm.longitude
        report(lon, lat, self.ctm_averaged_vcd, self.ctm_averaged_vcd_corrected,
               self.sat_averaged_vcd, self.sat_averaged_error, self.increment_OI,
               self.ak_OI, self.error_OI, self.aux1, self.aux2, fname, folder, gasname)

    def savedaily(self, folder, gasname, date):
        os.makedirs(folder, exist_ok=True)
        latitude, longitude = self._daily_latlon()
        for counter, sat in enumerate(self.reader_obj.sat_data):
            if sat is None:
                continue
            self._write_daily_mat(folder, gasname, counter, sat.time,
                                  sat.vcd, sat.ctm_vcd, sat.uncertainty,
                                  latitude, longitude)

    def write_to_nc(self, output_file, output_folder="diag"):
        os.makedirs(output_folder, exist_ok=True)
        idx = self._first_valid()
        sat = self.reader_obj.sat_data[idx]
        with np.errstate(invalid="ignore", divide="ignore"):
            scaling_factor = self.ctm_averaged_vcd_corrected / self.ctm_averaged_vcd
        scaling_factor = np.where(
            np.isnan(scaling_factor) | np.isinf(scaling_factor) | (scaling_factor == 0.0),
            1.0, scaling_factor)  # reference driver.py:204-209
        fields = {
            "sat_averaged_vcd": self.sat_averaged_vcd,
            "ctm_averaged_vcd_prior": self.ctm_averaged_vcd,
            "ctm_averaged_vcd_posterior": self.ctm_averaged_vcd_corrected,
            "sat_averaged_error": self.sat_averaged_error,
            "ak_OI": self.ak_OI,
            "error_OI": self.error_OI,
            "scaling_factor": scaling_factor,
            "lon": sat.longitude_center,
            "lat": sat.latitude_center,
            "aux1": self.aux1,
            "aux2": self.aux2,
        }
        # binned Desroziers runs (desroziers_bins > 1) diagnose PER-CELL
        # Sa/So scale maps; persist them so the tuning is auditable from
        # the diag file alone (extension field — downstream tools read by
        # name and ignore extras; scalar/global runs write nothing here)
        if getattr(self, "desroziers_sa_scale_map", None) is not None:
            fields["desroziers_sa_scale"] = self.desroziers_sa_scale_map
            fields["desroziers_so_scale"] = self.desroziers_so_scale_map
        write_diag_nc(os.path.join(output_folder, output_file + ".nc"), fields,
                      self.avg_time.strftime("%Y-%m-%d %H:%M:%S"),
                      global_attrs=getattr(self, "oi_diagnostics", None))
