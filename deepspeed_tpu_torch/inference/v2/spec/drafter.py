"""Model-free speculative drafters.

Port of ``deepspeed_tpu/inference/v2/spec/drafter.py``, unchanged: host numpy
over the request's history and the port's ``PrefixCache.lookup_continuation``,
so both packages draft the same tokens from the same history and trie.

Role model: prompt-lookup decoding (Saxena) / n-gram speculative drafting as
shipped in vLLM and transformers — draft tokens come from cheap host-side
pattern matching instead of a second model, so drafting costs microseconds
and is exact-cost-free when rejected (the verify forward prices ``1+k``
positions for the cost of one ragged dispatch).

Two mining sources, tried in order:

1. **prefix-cache trie** (when the scheduler runs one): the radix trie holds
   the token histories of every published sequence — if the request's own
   history is an indexed path, the children spell out exactly what a previous
   request generated after the same tokens (the repeated-request /
   multi-turn / templated-traffic shape, 100% acceptance under greedy);
2. **self prompt-lookup**: the longest n-gram suffix of the request's own
   history that occurred earlier in that history; the tokens that followed
   the earlier occurrence become the draft (the code/chat repetition shape).

The drafter is stateless; per-request adaptation (the acceptance EWMA that
shrinks ``k`` to 0 on adversarial text) lives with the request in the
serving scheduler.
"""

from typing import Optional

import numpy as np


class PromptLookupDrafter:
    """N-gram prompt-lookup over a token history, plus optional continuation
    mining from a :class:`~deepspeed_tpu_torch.inference.v2.ragged.prefix_cache.
    PrefixCache` trie. ``draft`` never proposes more than ``k`` tokens and
    returns empty when no source matches — the caller falls back to the plain
    single-token decode step (k=0)."""

    def __init__(self, min_ngram: int = 1, max_ngram: int = 3,
                 prefix_cache=None):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram "
                             f"(got {min_ngram}, {max_ngram})")
        self._min_ngram = int(min_ngram)
        self._max_ngram = int(max_ngram)
        self._prefix_cache = prefix_cache

    def draft(self, history, k: int, digests=None) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens of ``history`` (the
        request's prompt + generated tokens, most recent last). ``digests``
        is the history's precomputed full-block digest chain when the caller
        has one (the scheduler hashes each prompt once at admission)."""
        if k <= 0:
            return np.empty(0, np.int32)
        history = np.asarray(history, np.int32).reshape(-1)
        if self._prefix_cache is not None:
            toks = self._prefix_cache.lookup_continuation(history, k,
                                                          digests=digests)
            if toks.size:
                return toks
        return self._self_lookup(history, k)

    def _self_lookup(self, history: np.ndarray, k: int) -> np.ndarray:
        """Longest-n-gram suffix match within the history itself: the MOST
        RECENT earlier occurrence wins (recency tracks the local pattern —
        the convention prompt-lookup implementations share)."""
        H = history.size
        for n in range(min(self._max_ngram, H - 1), self._min_ngram - 1, -1):
            pattern = history[H - n:]
            # candidate start positions of earlier occurrences (the suffix
            # itself starts at H - n and is excluded)
            windows = np.lib.stride_tricks.sliding_window_view(history, n)
            hits = np.nonzero((windows[:H - n] == pattern).all(axis=1))[0]
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n  # continuation of the freshest match
            if start >= H:
                continue
            return np.array(history[start:start + k], np.int32, copy=True)
        return np.empty(0, np.int32)
