"""Token trees for speculative tree-verification.

Port of ``deepspeed_tpu/inference/v2/spec/tree.py``, unchanged: numpy on the
host, with the same packing the port's ragged wrapper and tree-verify forward
consume.

Role model: Medusa/SpecInfer-style tree attention — a draft step proposes a
small TREE of candidate continuations instead of a single chain, and ONE
ragged verify forward scores every node with a tree-attention mask (each node
attends only to the committed prefix plus its own ancestor path). The
scheduler then walks the tree with the exact spec-off sampling rule and
accepts the deepest matching path, so speculative output stays
token-identical to non-speculative output at the same seed wherever the
verify and decode logits pick the same tokens (always in f32 on the CPU).

Packing format (what the ragged wrapper / tree-verify program consume):

- ``tokens[i]``  — node i's token id; node 0 is the ROOT: the sequence's
  next-input token (already sampled, not yet committed), never a draft;
- ``parents[i]`` — node i's parent as a LOCAL node index (``parents[0] == -1``),
  in topological order (``parents[i] < i``), so ancestor closures resolve by
  simple pointer-chasing;
- ``depths[i]``  — root distance (``depths[0] == 0``); a node's LOGICAL
  (RoPE) position is ``seen_tokens + depths[i]`` while its KV SLOT is
  ``seen_tokens + i`` — sibling branches occupy distinct cache slots and the
  accepted path is re-packed to contiguous slots afterwards
  (``engine_v2.compact_accepted``).

A linear 1+k verify feed is the degenerate chain tree (``parents[i] == i-1``).
"""

from typing import Dict, List, Optional

import numpy as np


class TokenTree:
    """An immutable draft tree in topological (parent-before-child) order."""

    __slots__ = ("tokens", "parents", "depths", "_children")

    def __init__(self, tokens, parents, depths=None):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.parents = np.asarray(parents, np.int32).reshape(-1)
        n = self.tokens.size
        if n < 1:
            raise ValueError("a token tree needs at least the root node")
        if self.parents.size != n:
            raise ValueError(f"parents size {self.parents.size} != tokens size {n}")
        if self.parents[0] != -1:
            raise ValueError("node 0 is the root (parents[0] must be -1)")
        if any(not (-1 <= int(self.parents[i]) < i) for i in range(n)) or \
                any(int(p) == -1 for p in self.parents[1:]):
            raise ValueError("parents must be topological: 0 <= parents[i] < i "
                             "for every non-root node")
        if depths is None:
            d = np.zeros(n, np.int32)
            for i in range(1, n):
                d[i] = d[self.parents[i]] + 1
            self.depths = d
        else:
            self.depths = np.asarray(depths, np.int32).reshape(-1)
            if self.depths.size != n or self.depths[0] != 0 or any(
                    int(self.depths[i]) != int(self.depths[self.parents[i]]) + 1
                    for i in range(1, n)):
                raise ValueError("depths must satisfy depths[i] == depths[parent]+1")
        self._children: Optional[Dict[int, List[int]]] = None

    @classmethod
    def chain(cls, tokens) -> "TokenTree":
        """The degenerate linear tree: token i's parent is token i-1."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = tokens.size
        return cls(tokens, np.arange(-1, n - 1, dtype=np.int32),
                   np.arange(n, dtype=np.int32))

    @property
    def size(self) -> int:
        return int(self.tokens.size)

    @property
    def max_depth(self) -> int:
        return int(self.depths.max())

    @property
    def is_chain(self) -> bool:
        return bool((self.parents == np.arange(-1, self.size - 1)).all())

    def children(self, node: int) -> List[int]:
        if self._children is None:
            kids: Dict[int, List[int]] = {}
            for i in range(1, self.size):
                kids.setdefault(int(self.parents[i]), []).append(i)
            self._children = kids
        return self._children.get(int(node), [])

    def child_with_token(self, node: int, token: int) -> Optional[int]:
        """The lowest-index child of ``node`` carrying ``token`` (the
        acceptance walk descends here when the target model's draw matches a
        drafted branch), or None — the walk stops and the remaining subtree
        is rejected."""
        for c in self.children(node):
            if int(self.tokens[c]) == int(token):
                return c
        return None

    def __repr__(self):
        return (f"TokenTree(nodes={self.size}, depth={self.max_depth}, "
                f"chain={self.is_chain})")
