"""Serving-side controller for the tiered KV memory ladder.

The mechanism lives in ``inference/v2/ragged/tiering.py`` (the host→disk
store under ``BlockedKVCache``); this module is the *policy* layer the
serving scheduler drives:

- at scheduler construction, retrofit the engine's tiered store with the
  operator's budget/spill config (the engine is built before the serving
  config arrives — ``TieredKVStore.configure`` exists for exactly this);
- under KV pressure, demote in preference order: prefix-trie nodes
  device→host first (idle cached state, promotes back on the next hit),
  then already-offloaded sessions host→disk (coldest first) — freeing
  capacity WITHOUT discarding anything, which is what lets brownout demote
  before it sheds;
- keep the ``serving_kv_tier_*`` gauges current and assemble the per-tier
  stats block ``/v1/stats`` publishes.

Port of ``deepspeed_tpu/serving/kv_tiers.py`` (host Python, unchanged in
behaviour).
"""

from typing import Optional

from deepspeed_tpu_torch.serving.config import KVTierConfig


class KVTierController:
    """Policy driver over one engine's :class:`TieredKVStore`.

    All demotion entry points run on the scheduler (engine-owning) thread —
    the same thread that owns every other trie/allocator touch. The stats
    snapshot is safe from any thread (the store locks internally; counters
    are scalar reads).
    """

    def __init__(self, engine, config: KVTierConfig, metrics=None):
        self._engine = engine
        self._config = config
        self._metrics = metrics
        kv = engine._state_manager.kv_cache
        kv.configure_tiering(spill_dir=config.spill_dir,
                             host_bytes=config.host_bytes)
        self._kv = kv
        self.demotions = 0        # device blocks demoted by pressure policy
        self.promotions_seen = 0  # trie promotions observed at last gauge tick

    @property
    def demote_batch(self) -> int:
        return self._config.demote_batch

    # ------------------------------------------------------------- demotion --
    def demote_for_pressure(self, prefix_cache, active_requests) -> int:
        """One pressure-relief pass: demote up to ``demote_batch`` device
        blocks' worth of idle cached state down the ladder. Trie nodes go
        first (device→host — each frees one device block immediately); any
        remaining budget pushes the coldest host-resident *offloaded*
        sessions to disk (freeing host budget so future demotions have
        somewhere to land). Returns the number of demotions performed —
        the brownout controller skips shedding on any tick where this is
        non-zero."""
        budget = self._config.demote_batch
        demoted = 0
        if prefix_cache is not None:
            demoted += prefix_cache.demote(budget)
        if demoted < budget:
            demoted += self._demote_offloaded(active_requests,
                                              budget - demoted)
        if demoted:
            self.demotions += demoted
            if self._metrics:
                self._metrics.kv_tier_demotions.inc(demoted)
        return demoted

    def _demote_offloaded(self, active_requests, budget: int) -> int:
        """Push the coldest host-tier offloaded sessions toward disk."""
        sm = self._engine._state_manager
        candidates = [r for r in active_requests
                      if r.uid is not None and sm.is_offloaded(r.uid)
                      and sm.sequence_tier(r.uid) == "host"]
        candidates.sort(key=lambda r: r._last_touch_s)
        demoted = 0
        for req in candidates[:budget]:
            if sm.demote_sequence(req.uid):
                demoted += 1
                if self._metrics:
                    self._metrics.kv_tier_disk_demotions.inc()
        return demoted

    # ---------------------------------------------------------------- stats --
    def update_gauges(self, prefix_cache=None) -> None:
        if not self._metrics:
            return
        s = self._kv.tier_stats()
        self._metrics.kv_tier_device_blocks.set(
            self._kv.num_blocks - self._kv.free_blocks)
        self._metrics.kv_tier_host_blocks.set(s["host_blocks"])
        self._metrics.kv_tier_disk_blocks.set(s["disk_blocks"])
        if prefix_cache is not None:
            promotions = prefix_cache.tier_promotions
            if promotions > self.promotions_seen:
                self._metrics.kv_tier_promotions.inc(
                    promotions - self.promotions_seen)
                self.promotions_seen = promotions

    def stats(self, prefix_cache=None) -> dict:
        """The ``/v1/stats`` tier block: store occupancy per tier plus the
        policy-level counters."""
        doc = dict(self._kv.tier_stats())
        doc["enabled"] = True
        doc["device_blocks_used"] = self._kv.num_blocks - self._kv.free_blocks
        doc["device_blocks_total"] = self._kv.num_blocks
        doc["pressure_demotions"] = self.demotions
        if prefix_cache is not None:
            doc["trie_offloaded_nodes"] = prefix_cache.offloaded_nodes
            doc["trie_demotions"] = prefix_cache.tier_demotions
            doc["trie_promotions"] = prefix_cache.tier_promotions
        return doc


def maybe_create(engine, config: KVTierConfig,
                 metrics=None) -> Optional[KVTierController]:
    """None when tiering is disabled — the scheduler's hot paths stay one
    ``is None`` check, mirroring the ``ServingMetrics.maybe_create`` idiom."""
    if not config.enabled:
        return None
    return KVTierController(engine, config, metrics=metrics)
