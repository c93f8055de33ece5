"""Speculative decoding: drafters for the ragged decode path.

Port of ``deepspeed_tpu/inference/v2/spec/``.

The drafter proposes cheap draft tokens per sequence per decode step; the
engine's verify step prices every proposed position in ONE ragged forward
and the scheduler accepts under the spec-off sampling rule — >1 token per
decode dispatch, exact spec-off equivalence always. Two drafter families:

- :class:`PromptLookupDrafter` — model-free n-gram lookup (drafter.py); a
  LINEAR draft verified by ``engine_v2.verify``; wins on repetitive text,
  degrades to k=0 elsewhere;
- :class:`LearnedDrafter` over a :class:`MedusaDraftHead` (learned.py) —
  tiny trained heads reading the target's hidden state; proposes a
  :class:`TokenTree` (tree.py) of candidate branches verified in one ragged
  forward by ``engine_v2.verify_tree`` under the tree-attention mask; wins
  on arbitrary text after self-distillation (distill.py).
"""

from deepspeed_tpu_torch.inference.v2.spec.drafter import PromptLookupDrafter
from deepspeed_tpu_torch.inference.v2.spec.learned import LearnedDrafter, MedusaDraftHead
from deepspeed_tpu_torch.inference.v2.spec.tree import TokenTree

__all__ = ["LearnedDrafter", "MedusaDraftHead", "PromptLookupDrafter", "TokenTree"]
