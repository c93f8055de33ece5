"""Predicted-vs-observed perf ledger: live dispatch timings joined against
the roofline price.

Port of ``deepspeed_tpu/perf/observed.py``: the same programs, buckets,
compile amnesty, baseline and drift, priced against the port's card table
(``perf/chip_specs.py``, the H100 by default).

- the serving scheduler installs an engine ``dispatch_observer``; every
  engine dispatch (``put`` / ``decode_loop`` / ``verify`` / ``verify_tree``)
  reports its (kind, sequences, tokens, seconds). With an observer installed
  the port's engine waits for the dispatch's device work before it takes the
  end time, so the seconds are the card's, not the launches';
- each dispatch maps to the program that models it and a padded token
  bucket, lands in a ``perf_observed_dispatch_seconds{program,bucket}``
  histogram, and updates ``perf_observed_ratio{program,bucket}`` =
  observed / roofline-predicted step seconds;
- the FIRST sight of a (program, bucket) is **compile amnesty**, as in the
  JAX package: its seconds are excluded from the histogram and baseline and
  returned to the caller, which bills them to the requests in the batch as
  ``amnesty_seconds`` instead of device time. On the card the first sight
  carries one-time work (a kernel's first build and load, cuBLAS's first
  choice of algorithm for a shape);
- drift: each (program, bucket) freezes a baseline ratio from its first
  ``baseline_dispatches`` post-amnesty observations; a run of
  ``drift_consecutive`` dispatches whose ratio exceeds ``drift_factor`` x
  baseline raises a drift event (``perf_drift_events_total{program}`` + a
  ``perf_drift`` registry event), which the time-series store samples and
  the SLO engine can alarm on.

The analytic price (:class:`~deepspeed_tpu_torch.telemetry.ledger.PriceBook`)
bills a full weight read per token, so a prefill's "predicted" seconds grow
with its tokens where the card reads the weights once per dispatch; the
ratio is then far under 1 for prefill. Drift is baseline-relative and does
not depend on that.

Like the cost ledger, this object only exists while a telemetry session is
active; with telemetry off the engine's observer slot stays None and the
dispatch path pays a single attribute load.
"""

from deepspeed_tpu_torch.perf.chip_specs import DEFAULT_CHIP, get_chip_spec

# engine dispatch kind -> the flagship program whose roofline models it; a
# `put` whose feeds are all single tokens IS a paged decode step
_KIND_PROGRAM = {
    "decode_loop": "paged_decode_step",
    "verify": "spec_verify_step",
    "verify_tree": "spec_tree_verify",
}


def _bucket(tokens: int) -> int:
    """Padded token bucket: next power of two (the engine pads ragged batches
    to bucketed shapes, so wall times cluster by bucket, not exact size)."""
    b = 1
    while b < tokens:
        b <<= 1
    return b


class _KeyState:
    __slots__ = ("hist", "ratio_gauge", "dispatches", "amnestied",
                 "baseline", "_baseline_sum", "_baseline_n",
                 "over_run", "drift_events", "last_ratio", "predicted_s")

    def __init__(self, hist, ratio_gauge, predicted_s):
        self.hist = hist
        self.ratio_gauge = ratio_gauge
        self.predicted_s = predicted_s
        self.dispatches = 0
        self.amnestied = False
        self.baseline = None
        self._baseline_sum = 0.0
        self._baseline_n = 0
        self.over_run = 0
        self.drift_events = 0
        self.last_ratio = None


class PerfObservedLedger:

    def __init__(self, registry, pricebook, chip: str = DEFAULT_CHIP,
                 drift_factor: float = 4.0, drift_consecutive: int = 3,
                 baseline_dispatches: int = 8):
        self._registry = registry
        self._pricebook = pricebook
        self._chip = get_chip_spec(chip or DEFAULT_CHIP)
        self._drift_factor = float(drift_factor)
        self._drift_consecutive = max(1, int(drift_consecutive))
        self._baseline_dispatches = max(1, int(baseline_dispatches))
        self._keys = {}           # (program, bucket) -> _KeyState
        self._predictions = {}    # program -> explicit step_s override
        self._drift_counters = {}  # program -> counter

    # ------------------------------------------------------------ predictions --
    def load_predictions(self, step_s_by_program: dict) -> None:
        """Install explicit per-program predicted step seconds (e.g. from a
        perf-gate budgets file); they override the analytic roofline price for
        every bucket of that program."""
        self._predictions.update({str(k): float(v)
                                  for k, v in step_s_by_program.items()})

    def _predicted_s(self, program: str, bucket: int) -> float:
        explicit = self._predictions.get(program)
        if explicit is not None:
            return explicit
        # analytic roofline over the price book's per-token facts: the step
        # can be no faster than the busiest resource
        compute_s = self._pricebook.flops(bucket) / self._chip.peak_bf16_flops
        memory_s = self._pricebook.bytes(bucket) / self._chip.hbm_bytes_per_s
        return max(compute_s, memory_s, 1e-12)

    # -------------------------------------------------------------- observing --
    @staticmethod
    def program_for(kind: str, n_seqs: int, n_tokens: int) -> str:
        mapped = _KIND_PROGRAM.get(kind)
        if mapped is not None:
            return mapped
        # `put`: multi-token feeds are prefill chunks, all-single-token feeds
        # are one decode step
        return "prefix_suffix_prefill" if n_tokens > n_seqs else "paged_decode_step"

    def observe(self, kind: str, n_seqs: int, n_tokens: int, seconds: float) -> float:
        """Record one dispatch; returns the compile-amnesty seconds (the whole
        wall time on first sight of a (program, bucket), else 0.0)."""
        program = self.program_for(kind, n_seqs, n_tokens)
        bucket = _bucket(max(1, n_tokens))
        key = (program, bucket)
        st = self._keys.get(key)
        if st is None:
            labels = {"program": program, "bucket": str(bucket)}
            st = self._keys[key] = _KeyState(
                self._registry.histogram(
                    "perf_observed_dispatch_seconds",
                    "wall seconds around the engine's jitted dispatches, by program/bucket",
                    labels=labels),
                self._registry.gauge(
                    "perf_observed_ratio",
                    "observed dispatch seconds over roofline-predicted step seconds",
                    labels=labels),
                self._predicted_s(program, bucket))
        if not st.amnestied:
            # first sight of this (program, bucket): the compile dominates
            st.amnestied = True
            return seconds
        ratio = seconds / st.predicted_s
        st.dispatches += 1
        st.last_ratio = ratio
        st.hist.observe(seconds)
        st.ratio_gauge.set(ratio)
        if st.baseline is None:
            st._baseline_sum += ratio
            st._baseline_n += 1
            if st._baseline_n >= self._baseline_dispatches:
                st.baseline = st._baseline_sum / st._baseline_n
            return 0.0
        if ratio > self._drift_factor * st.baseline:
            st.over_run += 1
            if st.over_run >= self._drift_consecutive:
                st.over_run = 0
                self._drift(program, bucket, st, ratio)
        else:
            st.over_run = 0
        return 0.0

    def _drift(self, program: str, bucket: int, st: _KeyState, ratio: float) -> None:
        st.drift_events += 1
        counter = self._drift_counters.get(program)
        if counter is None:
            counter = self._drift_counters[program] = self._registry.counter(
                "perf_drift_events_total",
                "sustained observed-vs-predicted dispatch-time drift episodes",
                labels={"program": program})
        counter.inc()
        self._registry.event("perf_drift", program=program, bucket=bucket,
                             ratio=round(ratio, 3),
                             baseline=round(st.baseline, 3),
                             factor=self._drift_factor,
                             predicted_s=st.predicted_s)

    # ---------------------------------------------------------------- reading --
    def doc(self) -> dict:
        """The /v1/stats ``perf`` block: the live predicted-vs-observed join."""
        rows = []
        for (program, bucket), st in sorted(self._keys.items()):
            rows.append({
                "program": program,
                "bucket": bucket,
                "dispatches": st.dispatches,
                "predicted_s": st.predicted_s,
                "observed_p50_s": st.hist.quantile(0.5),
                "ratio": st.last_ratio,
                "baseline_ratio": st.baseline,
                "drift_events": st.drift_events,
            })
        return {"chip": self._chip.name,
                "drift_factor": self._drift_factor,
                "programs": rows}
