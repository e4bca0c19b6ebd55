"""Compile-wall accounting.

A process's cold-start cost is ``(number of distinct XLA programs) x
(compile latency)``, so the first step of attacking it is *counting the programs a workload actually
compiles*.  :class:`CompileCensus` listens to JAX's monitoring events and
records every backend compile with its duration and a caller-supplied
phase label, so a month/year run can print exactly which stage compiled
what and how long the service took.

Usage::

    with CompileCensus() as census:
        census.phase("month-1 OMI")
        run_month(...)
        census.phase("month-2 OMI")
        run_month(...)
    print(census.report())

``bench.py --year`` wires this in and emits the census in its JSON detail;
``OISAT_COMPILE_CENSUS=1`` makes run/job.py print one at exit.
"""

from __future__ import annotations

import time

import jax.monitoring

# every backend compile funnels through this event (jax 0.9 logs
# '/jax/core/compile/backend_compile_duration' on all backends; older
# versions used '/jax/backend_compile')
_COMPILE_EVENTS = ("/jax/core/compile/backend_compile",
                   "/jax/backend_compile")


class CompileCensus:
    """Counts XLA backend compiles and their durations, grouped by a
    user-advanced phase label."""

    def __init__(self, capture_names: bool = False):
        self.records = []  # (phase, event, seconds, wall_time)
        self.names = []  # (phase, program_name) — when capture_names
        self._phase = "start"
        self._listener = None
        self._t0 = None
        self._capture_names = capture_names
        self._log_handler = None
        self._log_compiles_prev = None

    def phase(self, label: str):
        self._phase = str(label)

    # -- context manager ----------------------------------------------------
    def __enter__(self):
        def listener(event: str, duration: float, **kw):
            if any(event.startswith(e) for e in _COMPILE_EVENTS):
                self.records.append((self._phase, event, float(duration),
                                     time.time()))

        self._listener = listener
        jax.monitoring.register_event_duration_secs_listener(listener)
        if self._capture_names:
            # the monitoring event carries no program name; the
            # jax_log_compiles "Compiling jit(<name>) with global shapes"
            # record does — capture it with a logging handler so the
            # census can NAME each program in the cold wall
            import logging
            import re

            census = self

            class _H(logging.Handler):
                def emit(self, rec):
                    m = re.search(r"Compiling (\S+?) with", rec.getMessage())
                    if m:
                        census.names.append((census._phase, m.group(1)))

            self._log_handler = _H(level=logging.DEBUG)
            logger = logging.getLogger("jax._src.interpreters.pxla")
            logger.addHandler(self._log_handler)
            self._log_compiles_prev = jax.config.jax_log_compiles
            jax.config.update("jax_log_compiles", True)
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        from jax._src import monitoring

        monitoring.unregister_event_duration_listener(self._listener)
        if self._log_handler is not None:
            import logging

            logging.getLogger("jax._src.interpreters.pxla").removeHandler(
                self._log_handler)
            jax.config.update("jax_log_compiles", self._log_compiles_prev)
        return False

    # -- reporting ------------------------------------------------------------
    @property
    def n_compiles(self) -> int:
        return len(self.records)

    @property
    def total_seconds(self) -> float:
        return sum(r[2] for r in self.records)

    def by_phase(self) -> dict:
        out: dict = {}
        for phase, _event, dur, _t in self.records:
            d = out.setdefault(phase, {"compiles": 0, "seconds": 0.0})
            d["compiles"] += 1
            d["seconds"] = round(d["seconds"] + dur, 2)
        return out

    def names_by_phase(self) -> dict:
        out: dict = {}
        for phase, name in self.names:
            out.setdefault(phase, []).append(name)
        return out

    def report(self) -> dict:
        rep = {"total_compiles": self.n_compiles,
               "total_compile_seconds": round(self.total_seconds, 2),
               "by_phase": self.by_phase()}
        if self.names:
            rep["program_names_by_phase"] = self.names_by_phase()
        return rep

    def pretty(self) -> str:
        lines = [f"compile census: {self.n_compiles} programs, "
                 f"{self.total_seconds:.1f}s in the compiler"]
        for phase, d in self.by_phase().items():
            lines.append(f"  {phase}: {d['compiles']} compiles, "
                         f"{d['seconds']:.1f}s")
        return "\n".join(lines)
