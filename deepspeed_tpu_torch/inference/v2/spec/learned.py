"""Learned draft heads: Medusa-style drafting over the target's hidden state.

Port of ``deepspeed_tpu/inference/v2/spec/learned.py``, unchanged: the heads
stay numpy on the host, and ``head_id`` and the ``.npz`` layout are the
reference's, so a head saved by either package loads in the other and a
handoff between them keeps its drafter state.

Role model: Medusa (Cai et al.) / EAGLE-class drafters — instead of a second
autoregressive model, ``num_heads`` tiny MLP heads read the TARGET model's
last hidden state (the pre-unembed residual the verify forward already
computed) and each predicts one future offset: head ``h`` guesses the token
``h + 2`` positions past the hidden state's own token. Drafting is a few
numpy GEMVs on the host — no extra device dispatch, no second KV cache —
and unlike prompt-lookup it proposes on text that never repeats, because the
heads are trained (spec/distill.py) on the target model's OWN outputs.

Offset bookkeeping (the classic Medusa off-by-one): when the scheduler holds
hidden state for position ``t`` it has ALREADY emitted token ``t + 1`` (the
same forward's logits produced it). That emitted token becomes the tree
root; head ``h``'s candidates populate tree depth ``h + 1``.

The heads are per-offset independent (no path conditioning), so a token
tree built from them shares one candidate set per depth; the joint path
score is the product of per-head probabilities and the tree grows
best-first under the node budget (spec/tree.py carries it to the
tree-verify forward).
"""

import heapq
import io
from typing import List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.v2.spec.tree import TokenTree

_EPS = 1e-6


def _relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


def _log_softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max(axis=-1, keepdims=True)
    z = logits - m
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


class MedusaDraftHead:
    """``num_heads`` independent 2-layer MLP heads over an L2-normalized
    hidden state. Pure numpy and deterministic end to end — the same weights
    draft the same tree on every replica, which is what lets a handoff
    (serving/scheduler.py) resume speculation mid-request: the receiving
    replica checks ``head_id`` and keeps drafting where the sender stopped.
    """

    def __init__(self, params: List[dict], head_id: str) -> None:
        if not params:
            raise ValueError("need at least one draft head")
        self.params = params
        self.head_id = str(head_id)
        self.hidden_dim = int(params[0]["W1"].shape[0])
        self.vocab_size = int(params[0]["W2"].shape[1])

    # --- construction -----------------------------------------------------
    @classmethod
    def fresh(cls, hidden_dim: int, vocab_size: int, num_heads: int = 3,
              mlp_dim: Optional[int] = None, seed: int = 0) -> "MedusaDraftHead":
        if num_heads < 1:
            raise ValueError("need num_heads >= 1")
        mlp_dim = int(mlp_dim if mlp_dim is not None else 2 * hidden_dim)
        rng = np.random.default_rng(seed)
        params = []
        for _ in range(num_heads):
            params.append(dict(
                W1=(rng.standard_normal((hidden_dim, mlp_dim))
                    / np.sqrt(hidden_dim)).astype(np.float32),
                b1=np.zeros(mlp_dim, np.float32),
                W2=(rng.standard_normal((mlp_dim, vocab_size)) * 0.1
                    / np.sqrt(mlp_dim)).astype(np.float32),
                b2=np.zeros(vocab_size, np.float32),
            ))
        head_id = f"medusa-s{seed}-{num_heads}x{hidden_dim}v{vocab_size}"
        return cls(params, head_id)

    @property
    def num_heads(self) -> int:
        return len(self.params)

    # --- forward / training math -----------------------------------------
    @staticmethod
    def normalize(hidden: np.ndarray) -> np.ndarray:
        """L2-normalize rows: the target's residual magnitude drifts with
        depth and layer norm scale; the heads should read direction only."""
        hidden = np.asarray(hidden, np.float32)
        n = np.linalg.norm(hidden, axis=-1, keepdims=True)
        return hidden / np.maximum(n, _EPS)

    def head_logits(self, hidden: np.ndarray) -> np.ndarray:
        """[num_heads, ..., vocab] logits from (already raw) hidden state."""
        x = self.normalize(hidden)
        outs = []
        for p in self.params:
            a = _relu(x @ p["W1"] + p["b1"])
            outs.append(a @ p["W2"] + p["b2"])
        return np.stack(outs)

    def head_log_probs(self, hidden: np.ndarray) -> np.ndarray:
        return _log_softmax(self.head_logits(hidden))

    def loss_and_grads(self, hidden: np.ndarray,
                       targets: np.ndarray) -> Tuple[float, List[dict]]:
        """Mean cross-entropy over heads and examples, plus per-head grads.

        ``hidden`` is [N, hidden_dim] raw hidden states; ``targets`` is
        [num_heads, N] token ids (head ``h``'s row holds the token at offset
        ``h + 2``). Hand-written backward — the trainer must run where only
        numpy is guaranteed (no autograd dependency on the serving host)."""
        x = self.normalize(np.atleast_2d(hidden))
        targets = np.asarray(targets, np.int64)
        if targets.shape != (self.num_heads, x.shape[0]):
            raise ValueError("targets must be [num_heads, N] aligned with hidden")
        N = x.shape[0]
        total = 0.0
        grads = []
        for h, p in enumerate(self.params):
            z1 = x @ p["W1"] + p["b1"]
            a = _relu(z1)
            logits = a @ p["W2"] + p["b2"]
            logp = _log_softmax(logits)
            y = targets[h]
            total += -float(logp[np.arange(N), y].mean())
            dlogits = np.exp(logp)
            dlogits[np.arange(N), y] -= 1.0
            dlogits /= N
            da = dlogits @ p["W2"].T
            dz1 = da * (z1 > 0)
            grads.append(dict(
                W1=(x.T @ dz1).astype(np.float32),
                b1=dz1.sum(axis=0).astype(np.float32),
                W2=(a.T @ dlogits).astype(np.float32),
                b2=dlogits.sum(axis=0).astype(np.float32),
            ))
        return total / self.num_heads, grads

    # --- persistence ------------------------------------------------------
    def save(self, path) -> None:
        flat = {"head_id": np.array(self.head_id)}
        for h, p in enumerate(self.params):
            for k, v in p.items():
                flat[f"h{h}_{k}"] = v
        with open(path, "wb") as f:
            np.savez(f, **flat)

    @classmethod
    def load(cls, path) -> "MedusaDraftHead":
        if isinstance(path, (bytes, bytearray)):
            path = io.BytesIO(path)
        with np.load(path) as z:
            head_id = str(z["head_id"])
            params = []
            h = 0
            while f"h{h}_W1" in z:
                params.append({k: z[f"h{h}_{k}"] for k in ("W1", "b1", "W2", "b2")})
                h += 1
        return cls(params, head_id)


class LearnedDrafter:
    """Token-tree drafting from a :class:`MedusaDraftHead`.

    ``draft_tree`` grows the tree best-first by joint log-probability: pop
    the highest-scoring frontier node, commit it, push its children scored
    ``parent_score + logp(head[depth], token)``. Ties break on (depth,
    token id, insertion order) so the tree is bit-reproducible across hosts.
    """

    def __init__(self, head: MedusaDraftHead, width: int = 2,
                 node_budget: int = 8) -> None:
        if width < 1:
            raise ValueError("need width >= 1")
        if node_budget < 2:
            raise ValueError("need node_budget >= 2 (root + one draft node)")
        self.head = head
        self.width = int(width)
        self.node_budget = int(node_budget)

    def draft_tree(self, hidden: np.ndarray, root_token: int, k: int,
                   width: Optional[int] = None,
                   node_budget: Optional[int] = None) -> Optional[TokenTree]:
        """Build a draft tree rooted at the already-emitted ``root_token``.

        ``hidden`` is the target's hidden state for the position BEFORE the
        root token; head ``h`` supplies depth ``h + 1`` candidates. ``k``
        caps tree depth (matching the linear drafter's per-request adaptive
        k), the node budget caps total fed tokens under the ragged token
        budget. Returns None when no draft fits (k <= 0) — the caller falls
        back to the plain decode step."""
        width = self.width if width is None else int(width)
        node_budget = self.node_budget if node_budget is None else int(node_budget)
        depth_cap = min(int(k), self.head.num_heads)
        if depth_cap < 1 or node_budget < 2:
            return None
        logp = self.head_log_probs_cached(hidden)
        # per-depth candidate sets, deterministic order: score desc, token asc
        cand: List[List[Tuple[float, int]]] = []
        for h in range(depth_cap):
            idx = np.lexsort((np.arange(logp.shape[1]), -logp[h]))[:width]
            cand.append([(float(logp[h][t]), int(t)) for t in idx])

        tokens = [int(root_token)]
        parents = [-1]
        depths = [0]
        counter = 0
        heap: list = []
        for lp, t in cand[0]:
            heapq.heappush(heap, (-lp, 1, t, counter, 0))
            counter += 1
        while heap and len(tokens) < node_budget:
            neg, depth, tok, _, parent = heapq.heappop(heap)
            node = len(tokens)
            tokens.append(tok)
            parents.append(parent)
            depths.append(depth)
            if depth < depth_cap:
                for lp, t in cand[depth]:
                    heapq.heappush(heap, (neg - lp, depth + 1, t, counter, node))
                    counter += 1
        if len(tokens) < 2:
            return None
        return TokenTree(np.array(tokens, np.int32), np.array(parents, np.int32),
                         np.array(depths, np.int32))

    def head_log_probs_cached(self, hidden: np.ndarray) -> np.ndarray:
        return self.head.head_log_probs(np.asarray(hidden, np.float32).reshape(-1))
