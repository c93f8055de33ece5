"""SLO burn-rate engine over the metric time-series store.

Port of ``deepspeed_tpu/telemetry/slo.py`` (host Python; copied).

Declarative objectives (``telemetry.slo`` config) are evaluated on every
time-series tick with the multi-window burn-rate method from the Google SRE
workbook: burn rate = (observed bad fraction) / (allowed bad fraction), read
over a *fast* and a *slow* window, and an alert fires only when **both**
exceed the threshold — the fast window makes detection quick, the slow
window filters blips. One flight-recorder dump fires per breach *episode*
(armed again once both windows drop back under the threshold).

Objective kinds:

- ``ttft`` / ``itl`` / ``e2e`` — latency percentile objectives against the
  serving histograms: an observation is *bad* when it exceeds ``target_s``;
  the SLO promises at most ``1 - target_ratio`` of observations bad.
- ``error_rate`` — failures+timeouts over terminal outcomes; bad fraction is
  the windowed error ratio, allowed is ``1 - target_ratio``.
- ``goodput`` — completions over all admission outcomes (terminal states
  plus rejections/sheds); bad fraction is ``1 - goodput ratio``.
- ``perf_drift`` — observed-vs-predicted dispatch drift: drift events
  (``perf_drift_events_total``) over engine dispatches observed in the window
  (the ``perf_observed_dispatch_seconds`` count) — the alarm surface for the
  cost plane's perf ledger.

Everything here runs on the sampler thread, off the request path; the
zero-cost-when-disabled contract is inherited from the store.
"""

import threading

LATENCY_FAMILIES = {
    "ttft": "serving_ttft_seconds",
    "itl": "serving_inter_token_seconds",
    "e2e": "serving_e2e_latency_seconds",
}
_ERROR_BAD = ("serving_failures_total", "serving_timeouts_total")
_ERROR_TOTAL = ("serving_completions_total", "serving_failures_total",
                "serving_timeouts_total")
_GOODPUT_GOOD = ("serving_completions_total",)
_GOODPUT_TOTAL = ("serving_completions_total", "serving_failures_total",
                  "serving_timeouts_total", "serving_rejections_total",
                  "serving_shed_admission_total", "serving_shed_queue_total")


class _ObjectiveState:

    def __init__(self, spec):
        self.spec = spec
        self.fast_burn = 0.0
        self.slow_burn = 0.0
        self.in_breach = False
        self.breaches = 0


class SLOEngine:
    """Evaluates configured objectives against a :class:`TimeSeriesStore`."""

    def __init__(self, config, store, registry):
        self.config = config
        self.store = store
        self.registry = registry
        self._lock = threading.Lock()
        self._objectives = [_ObjectiveState(spec) for spec in config.objectives]
        self._breach_counter = registry.counter(
            "slo_breaches_total",
            "SLO breach episodes (fast and slow burn both over threshold)")
        self._burn_gauges = {}
        for state in self._objectives:
            name = state.spec.name or state.spec.metric
            self._burn_gauges[name] = {
                w: registry.gauge("slo_burn_rate",
                                  "Error-budget burn rate per objective/window",
                                  labels={"slo": name, "window": w})
                for w in ("fast", "slow")}
        store.on_tick(lambda _store: self.evaluate())

    # ---------------------------------------------------------- burn rates --
    def _counter_fraction(self, bad_families, total_families, window_s):
        bad = total = 0.0
        for fam in total_families:
            delta = self.store.window_delta(fam, window_s)
            if delta is not None:
                total += delta
                if fam in bad_families:
                    bad += delta
        if total <= 0:
            return None
        return bad / total

    def _bad_fraction(self, spec, window_s):
        if spec.metric in LATENCY_FAMILIES:
            return self.store.window_bad_fraction(
                LATENCY_FAMILIES[spec.metric], spec.target_s, window_s)
        if spec.metric == "error_rate":
            return self._counter_fraction(_ERROR_BAD, _ERROR_TOTAL, window_s)
        if spec.metric == "goodput":
            frac = self._counter_fraction(
                tuple(f for f in _GOODPUT_TOTAL if f not in _GOODPUT_GOOD),
                _GOODPUT_TOTAL, window_s)
            return frac
        if spec.metric == "perf_drift":
            events = self.store.window_delta("perf_drift_events_total", window_s)
            dispatches = self.store.window_hist_delta(
                "perf_observed_dispatch_seconds", window_s)
            if events is None or dispatches is None or dispatches[0] <= 0:
                return None
            return max(0.0, min(1.0, events / dispatches[0]))
        return None

    def burn_rate(self, spec, window_s):
        """Observed bad fraction over allowed bad fraction, 0.0 with no
        traffic in the window (an empty budget burns nothing)."""
        bad_frac = self._bad_fraction(spec, window_s)
        if bad_frac is None:
            return 0.0
        allowed = max(1e-9, 1.0 - spec.target_ratio)
        return bad_frac / allowed

    # ---------------------------------------------------------- evaluation --
    def evaluate(self):
        """One multi-window pass over every objective (called per tick)."""
        for state in self._objectives:
            spec = state.spec
            name = spec.name or spec.metric
            fast = self.burn_rate(spec, spec.fast_window_s)
            slow = self.burn_rate(spec, spec.slow_window_s)
            with self._lock:
                state.fast_burn, state.slow_burn = fast, slow
                breaching = (fast >= spec.burn_threshold
                             and slow >= spec.burn_threshold)
                newly = breaching and not state.in_breach
                if newly:
                    state.in_breach = True
                    state.breaches += 1
                elif not breaching:
                    state.in_breach = False
            gauges = self._burn_gauges[name]
            gauges["fast"].set(fast)
            gauges["slow"].set(slow)
            if newly:
                self._breach(name, spec, fast, slow)

    def _breach(self, name, spec, fast, slow):
        self._breach_counter.inc()
        self.registry.event("slo_breach", slo=name, metric=spec.metric,
                            fast_burn=round(fast, 3), slow_burn=round(slow, 3),
                            burn_threshold=spec.burn_threshold)
        from deepspeed_tpu_torch import telemetry
        recorder = telemetry.get_flight_recorder()
        if recorder is not None:
            try:
                recorder.dump("slo_breach")
            except Exception:
                pass  # a failed dump must not break evaluation

    # ------------------------------------------------------------- signals --
    def in_breach(self):
        """True while any objective's breach episode is open — the
        config-gated input signal for brownout/autoscaling."""
        with self._lock:
            return any(s.in_breach for s in self._objectives)

    def breach_signal(self):
        """Max fast-window burn normalized by its threshold, clamped to
        [0, 1] — a pressure-like scalar for the BrownoutController."""
        with self._lock:
            if not self._objectives:
                return 0.0
            return max(0.0, min(1.0, max(
                s.fast_burn / max(1e-9, s.spec.burn_threshold)
                for s in self._objectives)))

    # -------------------------------------------------------------- export --
    def status(self):
        """Doc for ``/v1/fleet/slo`` and the ``/v1/stats`` ``slo`` block."""
        objectives = []
        with self._lock:
            for state in self._objectives:
                spec = state.spec
                objectives.append({
                    "name": spec.name or spec.metric,
                    "metric": spec.metric,
                    "target_s": spec.target_s,
                    "target_ratio": spec.target_ratio,
                    "fast_window_s": spec.fast_window_s,
                    "slow_window_s": spec.slow_window_s,
                    "burn_threshold": spec.burn_threshold,
                    "fast_burn": round(state.fast_burn, 4),
                    "slow_burn": round(state.slow_burn, 4),
                    "in_breach": state.in_breach,
                    "breaches": state.breaches,
                })
            in_breach = any(s.in_breach for s in self._objectives)
        return {"objectives": objectives, "in_breach": in_breach}
