"""Per-request / per-tenant cost-attribution ledger (the cost plane).

Port of ``deepspeed_tpu/telemetry/ledger.py``, with one repair (ROADMAP C5):
:meth:`PriceBook.from_model_config` takes the layer count from ``num_layers``
or else ``num_hidden_layers``. The JAX package reads ``num_layers`` only,
which neither package's ``LlamaConfig`` has, so it prices every Llama at the
fixed fallback; the port prices Llama analytically.

Three pieces, all scheduler-owned and telemetry-gated:

- :class:`PriceBook` — deterministic analytic pricing: flops / HBM bytes per
  token derived once from the model config (falls back to fixed constants when
  no config is reachable).  Pricing happens at *read* time over integer token
  counts, so per-tenant sums reconcile exactly against the aggregate — the
  conservation gate's invariant.
- :class:`RequestCost` — the per-request accumulator carried on
  ``Request.cost``: tokens billed per phase, device-seconds amortized over
  batch occupants, compile-amnesty seconds, KV block-seconds per tier, wire
  bytes per channel, and cache savings (prefix tokens served, spec tokens
  accepted).
- :class:`CostLedger` — the charging API plus an engine-level aggregate of the
  same fields (incremented at the same sites, so nothing can be double-billed
  or unattributed) and a bounded per-tenant rollup (:class:`TenantRollup`,
  overflow tenants fold into ``<other>`` so conservation still holds).

Zero-cost-when-disabled: ``CostLedger.maybe_create`` returns None unless a
telemetry session is active; every scheduler hot-path site is one
``if ledger is not None`` check.  The accumulators themselves are plain
Python — only the mirrored ``serving_cost_*`` / ``serving_tenant_*`` metric
families touch the registry.
"""

from typing import Optional

DEFAULT_TENANT = "default"
OTHER_TENANT = "<other>"

# phases the scheduler bills (the engine dispatch kinds, scheduler-side view)
PHASES = ("prefill", "decode", "verify", "tree_verify")

# fallbacks when no model config is reachable: arbitrary but fixed, so pricing
# stays deterministic across runs of the same build
_FALLBACK_FLOPS_PER_TOKEN = 2.0e6
_FALLBACK_BYTES_PER_TOKEN = 1.0e6


class PriceBook:
    """Deterministic (phase, tokens) -> (flops, bytes) pricing.

    The analytic model is the standard dense-transformer count: forward flops
    per token ~= 2 * params, and decode HBM traffic per token ~= the full
    parameter + KV read (approximated as ``param_bytes``).  The point is not
    chip-accurate accounting — the JAX package's HLO perf gates own that — but a *fixed,
    documented* price per token so tenant bills are comparable and the
    conservation gate can check exact reconciliation on integer token counts.
    """

    def __init__(self, flops_per_token: float = _FALLBACK_FLOPS_PER_TOKEN,
                 bytes_per_token: float = _FALLBACK_BYTES_PER_TOKEN,
                 source: str = "fallback"):
        self.flops_per_token = float(flops_per_token)
        self.bytes_per_token = float(bytes_per_token)
        self.source = source

    @classmethod
    def from_model_config(cls, cfg) -> "PriceBook":
        """Analytic pricing from a model config exposing the usual dense
        fields; any missing attribute falls back to the fixed constants."""
        try:
            h = int(cfg.hidden_size)
            # C5: Llama-family configs name the field num_hidden_layers
            layers = int(cfg.num_layers if hasattr(cfg, "num_layers") else cfg.num_hidden_layers)
            vocab = int(cfg.vocab_size)
            inter = int(getattr(cfg, "intermediate_size", 4 * h))
            # attention (4 h^2) + gated MLP (3 h*inter) per layer, plus the
            # embedding/unembedding matrix
            params = layers * (4 * h * h + 3 * h * inter) + vocab * h
            bytes_per_param = 2.0  # bf16 weights are the serving default
            return cls(flops_per_token=2.0 * params,
                       bytes_per_token=bytes_per_param * params,
                       source="analytic")
        except (AttributeError, TypeError, ValueError):
            return cls()

    def flops(self, tokens: int) -> float:
        return self.flops_per_token * tokens

    def bytes(self, tokens: int) -> float:
        return self.bytes_per_token * tokens

    def to_dict(self) -> dict:
        return {"flops_per_token": self.flops_per_token,
                "bytes_per_token": self.bytes_per_token,
                "source": self.source}


class _CostBase:
    """Shared accumulator fields for the per-request cost and the aggregate /
    per-tenant totals — same fields, charged at the same sites."""

    __slots__ = ("tokens", "drafted_tokens", "accepted_tokens",
                 "saved_prefix_tokens", "saved_spec_tokens",
                 "device_seconds", "amnesty_seconds", "dispatches",
                 "kv_block_seconds", "wire_bytes")

    def __init__(self):
        self.tokens = {p: 0 for p in PHASES}
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.saved_prefix_tokens = 0
        self.saved_spec_tokens = 0
        self.device_seconds = 0.0
        self.amnesty_seconds = 0.0
        self.dispatches = 0
        self.kv_block_seconds = {}   # tier -> float seconds
        self.wire_bytes = {}         # channel -> int bytes

    @property
    def billed_tokens(self) -> int:
        return sum(self.tokens.values())

    def doc(self, pricebook: Optional[PriceBook] = None) -> dict:
        billed = self.billed_tokens
        out = {
            "tokens": dict(self.tokens, billed=billed),
            "speculative": {"drafted": self.drafted_tokens,
                            "accepted": self.accepted_tokens},
            "saved_tokens": {"prefix": self.saved_prefix_tokens,
                             "spec": self.saved_spec_tokens},
            "device_seconds": round(self.device_seconds, 6),
            "amnesty_seconds": round(self.amnesty_seconds, 6),
            "dispatches": self.dispatches,
            "kv_block_seconds": {t: round(s, 6)
                                 for t, s in sorted(self.kv_block_seconds.items())},
            "wire_bytes": dict(sorted(self.wire_bytes.items())),
        }
        if pricebook is not None:
            out["flops"] = pricebook.flops(billed)
            out["hbm_bytes"] = pricebook.bytes(billed)
        return out


class RequestCost(_CostBase):
    """The accumulator carried on ``Request.cost`` (None with telemetry off).

    ``_kv_anchor`` implements piecewise-constant KV block-second accrual: the
    ledger closes the open segment and re-anchors on every block-count / tier
    transition it is told about, so occupancy between events is billed at the
    last known (blocks, tier)."""

    __slots__ = ("pricebook", "_kv_anchor")

    def __init__(self, pricebook: PriceBook):
        super().__init__()
        self.pricebook = pricebook
        self._kv_anchor = None  # (ts_s, blocks, tier)

    def to_dict(self) -> dict:
        return self.doc(self.pricebook)

    def compact_row(self) -> dict:
        """Cost-to-date for /v1/stats request rows and flight-recorder rows."""
        return {"billed_tokens": self.billed_tokens,
                "device_ms": round(self.device_seconds * 1e3, 3),
                "kv_block_s": round(sum(self.kv_block_seconds.values()), 3),
                "wire_bytes": sum(self.wire_bytes.values())}


class _Totals(_CostBase):
    __slots__ = ("requests",)

    def __init__(self):
        super().__init__()
        self.requests = 0

    def fold(self, cost: _CostBase):
        for p, n in cost.tokens.items():
            self.tokens[p] = self.tokens.get(p, 0) + n
        self.drafted_tokens += cost.drafted_tokens
        self.accepted_tokens += cost.accepted_tokens
        self.saved_prefix_tokens += cost.saved_prefix_tokens
        self.saved_spec_tokens += cost.saved_spec_tokens
        self.device_seconds += cost.device_seconds
        self.amnesty_seconds += cost.amnesty_seconds
        self.dispatches += cost.dispatches
        for t, s in cost.kv_block_seconds.items():
            self.kv_block_seconds[t] = self.kv_block_seconds.get(t, 0.0) + s
        for c, b in cost.wire_bytes.items():
            self.wire_bytes[c] = self.wire_bytes.get(c, 0) + b
        self.requests += 1


class TenantRollup:
    """Bounded tenant -> totals store.  Once ``max_tenants`` distinct tenants
    exist, later tenants fold into ``<other>`` — bounded memory, and the sum
    over rows still reconciles against the aggregate."""

    def __init__(self, max_tenants: int = 64):
        self.max_tenants = max(1, int(max_tenants))
        self._tenants = {}  # tenant -> _Totals

    def bucket_for(self, tenant: str) -> str:
        if tenant in self._tenants or len(self._tenants) < self.max_tenants:
            return tenant
        return OTHER_TENANT

    def fold(self, tenant: str, cost: _CostBase) -> str:
        bucket = self.bucket_for(tenant)
        totals = self._tenants.get(bucket)
        if totals is None:
            totals = self._tenants[bucket] = _Totals()
        totals.fold(cost)
        return bucket

    def items(self):
        return self._tenants.items()

    def doc(self, pricebook: Optional[PriceBook] = None) -> dict:
        return {tenant: dict(totals.doc(pricebook), requests=totals.requests)
                for tenant, totals in sorted(self._tenants.items())}


class CostLedger:
    """The charging API.  Created by the serving scheduler when (and only
    when) a telemetry session is active; every call site in the scheduler is
    behind one ``if self._ledger is not None`` check, so disabled telemetry
    pays nothing and the registry sees zero api_calls."""

    def __init__(self, registry, pricebook: Optional[PriceBook] = None,
                 max_tenants: int = 64, tenant_metric_top_k: int = 8,
                 default_tenant: str = DEFAULT_TENANT):
        self.pricebook = pricebook or PriceBook()
        self.default_tenant = default_tenant
        self.totals = _Totals()
        self.tenants = TenantRollup(max_tenants=max_tenants)
        self._tenant_metric_top_k = max(1, int(tenant_metric_top_k))
        self._registry = registry
        self._m_billed = {
            p: registry.counter(
                "serving_cost_billed_tokens_total",
                "tokens billed by the cost ledger, by engine phase",
                labels={"phase": p})
            for p in PHASES}
        self._m_device_s = registry.counter(
            "serving_cost_device_seconds_total",
            "dispatch wall-seconds attributed to requests (amortized over batch occupants)")
        self._m_amnesty_s = registry.counter(
            "serving_cost_amnesty_seconds_total",
            "dispatch wall-seconds forgiven as compile amnesty (first sight of a (program, bucket))")
        self._m_kv = {}    # tier -> counter
        self._m_wire = {}  # channel -> counter
        self._m_saved = {
            src: registry.counter(
                "serving_cost_saved_tokens_total",
                "tokens the request did NOT pay for (prefix-cache hits, accepted spec drafts)",
                labels={"source": src})
            for src in ("prefix", "spec")}
        self._tenant_m = {}  # tenant -> (tokens_counter, requests_counter)

    # ------------------------------------------------------------- lifecycle --
    def begin(self, req) -> None:
        req.cost = RequestCost(self.pricebook)

    def finalize(self, req, now_s: float) -> None:
        """Close the open KV segment and fold the request into its tenant's
        rollup (bounded; overflow tenants land in ``<other>``)."""
        cost = req.cost
        if cost is None:
            return
        self._close_kv(cost, now_s)
        tenant = req.tenant or self.default_tenant
        bucket = self.tenants.fold(tenant, cost)
        self.totals.requests += 1
        tokens_c, requests_c = self._tenant_metrics(bucket)
        tokens_c.inc(cost.billed_tokens)
        requests_c.inc()

    # -------------------------------------------------------------- charging --
    def charge_dispatch(self, members, seconds: float, amnesty_s: float = 0.0) -> None:
        """Attribute one engine dispatch to its batch members.

        ``members`` is ``[(cost, phase, tokens), ...]`` — the executed plan's
        view.  Wall time (and any compile-amnesty forgiveness) is amortized by
        each member's share of the dispatch's fed tokens."""
        total = sum(t for _, _, t in members)
        if total <= 0:
            return
        billed_by_phase = {}
        for cost, phase, tokens in members:
            cost.tokens[phase] = cost.tokens.get(phase, 0) + tokens
            self.totals.tokens[phase] = self.totals.tokens.get(phase, 0) + tokens
            share = tokens / total
            cost.device_seconds += seconds * share
            cost.amnesty_seconds += amnesty_s * share
            cost.dispatches += 1
            billed_by_phase[phase] = billed_by_phase.get(phase, 0) + tokens
        self.totals.device_seconds += seconds
        self.totals.amnesty_seconds += amnesty_s
        self.totals.dispatches += 1
        for phase, tokens in billed_by_phase.items():
            self._m_billed[phase].inc(tokens)
        self._m_device_s.inc(seconds)
        if amnesty_s:
            self._m_amnesty_s.inc(amnesty_s)

    def charge_spec(self, cost: RequestCost, drafted: int, accepted: int) -> None:
        cost.drafted_tokens += drafted
        cost.accepted_tokens += accepted
        cost.saved_spec_tokens += accepted
        self.totals.drafted_tokens += drafted
        self.totals.accepted_tokens += accepted
        self.totals.saved_spec_tokens += accepted
        if accepted:
            self._m_saved["spec"].inc(accepted)

    def charge_prefix(self, cost: RequestCost, tokens: int) -> None:
        cost.saved_prefix_tokens += tokens
        self.totals.saved_prefix_tokens += tokens
        if tokens:
            self._m_saved["prefix"].inc(tokens)

    def charge_wire(self, cost: RequestCost, channel: str, nbytes: int) -> None:
        cost.wire_bytes[channel] = cost.wire_bytes.get(channel, 0) + nbytes
        self.totals.wire_bytes[channel] = self.totals.wire_bytes.get(channel, 0) + nbytes
        counter = self._m_wire.get(channel)
        if counter is None:
            counter = self._m_wire[channel] = self._registry.counter(
                "serving_cost_wire_bytes_total",
                "KV payload bytes billed to requests, by motion channel",
                labels={"channel": channel})
        counter.inc(nbytes)

    def touch_kv(self, cost: RequestCost, blocks: int, tier: str, now_s: float) -> None:
        """Close the open occupancy segment and re-anchor at (blocks, tier)."""
        self._close_kv(cost, now_s)
        if blocks > 0:
            cost._kv_anchor = (now_s, int(blocks), tier)

    def _close_kv(self, cost: RequestCost, now_s: float) -> None:
        anchor = cost._kv_anchor
        if anchor is None:
            return
        ts, blocks, tier = anchor
        cost._kv_anchor = None
        dt = max(0.0, now_s - ts)
        if dt <= 0.0 or blocks <= 0:
            return
        amount = blocks * dt
        cost.kv_block_seconds[tier] = cost.kv_block_seconds.get(tier, 0.0) + amount
        self.totals.kv_block_seconds[tier] = \
            self.totals.kv_block_seconds.get(tier, 0.0) + amount
        counter = self._m_kv.get(tier)
        if counter is None:
            counter = self._m_kv[tier] = self._registry.counter(
                "serving_cost_kv_block_seconds_total",
                "KV block-seconds billed to requests, by residency tier",
                labels={"tier": tier})
        counter.inc(amount)

    # -------------------------------------------------------------- reading --
    def _tenant_metrics(self, tenant: str):
        m = self._tenant_m.get(tenant)
        if m is None:
            if len(self._tenant_m) >= self._tenant_metric_top_k and tenant != OTHER_TENANT:
                tenant = OTHER_TENANT
                m = self._tenant_m.get(tenant)
            if m is None:
                m = self._tenant_m[tenant] = (
                    self._registry.counter(
                        "serving_tenant_tokens_total",
                        "tokens billed per tenant (top-K tenants; overflow under <other>)",
                        labels={"tenant": tenant}),
                    self._registry.counter(
                        "serving_tenant_requests_total",
                        "finished requests per tenant (top-K tenants; overflow under <other>)",
                        labels={"tenant": tenant}))
        return m

    def usage_doc(self) -> dict:
        return {"enabled": True,
                "default_tenant": self.default_tenant,
                "pricing": self.pricebook.to_dict(),
                "totals": dict(self.totals.doc(self.pricebook),
                               requests=self.totals.requests),
                "tenants": self.tenants.doc(self.pricebook)}
