"""Serving telemetry on the unified registry (``deepspeed_tpu_torch/telemetry``).

Port of ``deepspeed_tpu/serving/metrics.py``, with the same metric names.

Zero-cost-when-disabled contract: ``ServingMetrics.maybe_create()`` returns
None unless a telemetry session is active, and every scheduler call site is
guarded by that None check — the disabled hot path performs no registry work
(the same unit-enforceable guarantee the engine and comm layers give).
"""

from typing import Optional

# TTFT/e2e live in the default latency decades; inter-token latency needs the
# sub-millisecond end emphasized (a fast decode step is ~100us-10ms)
_ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5)


class ServingMetrics:
    """The serving-layer metric family; one instance per scheduler."""

    def __init__(self, registry):
        self.queue_depth = registry.gauge(
            "serving_queue_depth", "Requests waiting for admission")
        self.in_flight = registry.gauge(
            "serving_in_flight_requests", "Requests in PREFILL or DECODE")
        self.ttft = registry.histogram(
            "serving_ttft_seconds", "Submission to first generated token")
        self.itl = registry.histogram(
            "serving_inter_token_seconds", "Gap between consecutive streamed tokens",
            buckets=_ITL_BUCKETS)
        self.e2e = registry.histogram(
            "serving_e2e_latency_seconds", "Submission to terminal state")
        self.admissions = registry.counter(
            "serving_admissions_total", "Requests accepted into the queue")
        self.rejections = registry.counter(
            "serving_rejections_total", "Requests rejected by backpressure")
        self.completions = registry.counter(
            "serving_completions_total", "Requests finished DONE")
        self.timeouts = registry.counter(
            "serving_timeouts_total", "Requests that hit their deadline")
        self.cancellations = registry.counter(
            "serving_cancellations_total", "Requests cancelled mid-flight")
        self.failures = registry.counter(
            "serving_failures_total", "Requests that FAILED")
        self.evictions = registry.counter(
            "serving_kv_evictions_total", "Idle sequences offloaded under KV pressure")
        # automatic prefix cache (inference/v2/ragged/prefix_cache.py)
        self.prefix_lookups = registry.counter(
            "serving_prefix_lookups_total", "Admitted prompts looked up in the prefix trie")
        self.prefix_hits = registry.counter(
            "serving_prefix_hits_total", "Admitted prompts served a cached prefix")
        self.prefix_lookup_depth = registry.histogram(
            "serving_prefix_lookup_depth_blocks",
            "Cached-prefix depth (KV blocks) applied per lookup",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256))
        self.prefix_tokens_saved = registry.counter(
            "serving_prefix_tokens_saved_total",
            "Prompt tokens served from cached KV instead of prefilled")
        self.prefix_trie_blocks = registry.gauge(
            "serving_prefix_trie_blocks", "Device KV blocks pinned by the prefix trie")
        self.prefix_evictions = registry.counter(
            "serving_prefix_evictions_total",
            "Prefix-trie leaves evicted (LRU) under KV pressure or the trie cap")
        # speculative decoding (inference/v2/spec/ + the scheduler's verify
        # execute path)
        self.spec_drafted = registry.counter(
            "serving_spec_draft_tokens_total",
            "Draft tokens proposed into speculative verify feeds")
        self.spec_accepted = registry.counter(
            "serving_spec_accepted_tokens_total",
            "Draft tokens the target model's verify step accepted")
        self.spec_verify_steps = registry.counter(
            "serving_spec_verify_steps_total",
            "Decode dispatches that carried at least one draft token")
        self.spec_rollback = registry.counter(
            "serving_spec_rollback_tokens_total",
            "Rejected draft positions truncated from committed KV (write-then-truncate)")
        self.spec_accept_rate = registry.gauge(
            "serving_spec_accept_rate",
            "EWMA of the speculative acceptance rate across verify steps")
        self.spec_tokens_per_step = registry.histogram(
            "serving_spec_tokens_per_step",
            "Tokens emitted per speculative verify step (1 = nothing accepted)",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16))
        # token-tree verification + drafter arbitration (learned/auto modes)
        self.spec_tree_nodes = registry.counter(
            "serving_spec_tree_nodes_total",
            "Token-tree nodes fed through verify_tree dispatches (root included)")
        self.spec_tree_accept_depth = registry.histogram(
            "serving_spec_tree_accept_depth",
            "Accepted path depth per tree-verify step (0 = root only survived)",
            buckets=(0, 1, 2, 3, 4, 6, 8))
        self.spec_tree_compactions = registry.counter(
            "serving_spec_tree_compactions_total",
            "Tree-verify steps whose accepted path needed a KV gather-compact "
            "(non-chain acceptance)")
        self.spec_drafter_switches = registry.counter(
            "serving_spec_drafter_switches_total",
            "Per-request drafter changes decided by the auto arbitration")
        self.spec_drafter_learned_ewma = registry.gauge(
            "serving_spec_drafter_learned_ewma",
            "EWMA of the learned drafter's accepted-depth rate across requests")
        self.spec_drafter_lookup_ewma = registry.gauge(
            "serving_spec_drafter_lookup_ewma",
            "EWMA of the prompt-lookup drafter's accepted-depth rate across requests")
        # overload control (serving/overload.py + scheduler admission/shed)
        self.shed_admission = registry.counter(
            "serving_shed_admission_total",
            "Requests rejected at admission: deadline provably unmeetable")
        self.shed_queue = registry.counter(
            "serving_shed_queue_total",
            "Queued requests shed under sustained overload pressure")
        self.brownout_stage = registry.gauge(
            "serving_brownout_stage",
            "Current brownout degradation stage (0 = normal service)")
        self.brownout_transitions = registry.counter(
            "serving_brownout_transitions_total",
            "Brownout stage changes (hysteresis-smoothed)")
        self.brownout_clamped = registry.counter(
            "serving_brownout_clamped_total",
            "Batch-class requests whose max_new_tokens was brownout-clamped")
        self.brownout_rejections = registry.counter(
            "serving_brownout_rejections_total",
            "Batch-class requests rejected outright at brownout stage 3")
        self.fair_share_sheds = registry.counter(
            "serving_fair_share_sheds_total",
            "Requests shed/429'd by the fair-share stage (tenant over measured "
            "share under pressure)")
        # tiered KV memory (inference/v2/ragged/tiering.py + serving/kv_tiers.py)
        self.kv_tier_demotions = registry.counter(
            "serving_kv_tier_demotions_total",
            "KV blocks demoted device->host under pressure (trie + eviction path)")
        self.kv_tier_disk_demotions = registry.counter(
            "serving_kv_tier_disk_demotions_total",
            "Offloaded sessions demoted host->disk (coldest first)")
        self.kv_tier_promotions = registry.counter(
            "serving_kv_tier_promotions_total",
            "Demoted trie nodes promoted back to device on a prefix hit")
        self.kv_tier_device_blocks = registry.gauge(
            "serving_kv_tier_device_blocks", "KV blocks resident on device")
        self.kv_tier_host_blocks = registry.gauge(
            "serving_kv_tier_host_blocks", "KV blocks resident in the host tier")
        self.kv_tier_disk_blocks = registry.gauge(
            "serving_kv_tier_disk_blocks", "KV blocks resident in spill files on disk")

    @classmethod
    def maybe_create(cls) -> Optional["ServingMetrics"]:
        from deepspeed_tpu_torch import telemetry
        if not telemetry.is_active():
            return None
        return cls(telemetry.get_registry())
