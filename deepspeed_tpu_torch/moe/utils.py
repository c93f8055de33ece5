"""MoE parameter groups.

Port of ``deepspeed_tpu/moe/utils.py``: :func:`is_moe_param` (the
``allreduce = False`` stamp that ``ExpertFFN`` puts on its banks, as upstream
DeepSpeed's expert layers do) and
:func:`split_params_into_different_moe_groups_for_optimizer`, over torch
parameter groups (dicts whose ``params`` is a list of tensors), with the
reference's rules: a group is made only where it has parameters, an expert
group is named ``<name>_moe`` (``moe_group_<i>`` when the input group has no
name) and carries ``moe: True``, and every other key of the input group is
copied to both.

:func:`moe_groups` gives a MoE layer its groups from the rank mesh: the
group its gate is global over (every rank that holds other tokens: the
data, expert and sequence ranks, never the model ranks, which hold the
same tokens), the expert group its banks are spread over and the
expert-data group that replicates them (the data and sequence ranks:
``groups.EXPERT_ZERO_AXES``). Expert gradients are summed over the
expert-data group, dense ones over data x seq.
"""

from typing import Dict, List

from deepspeed_tpu_torch.utils import groups


def is_moe_param(param) -> bool:
    """True for an expert parameter."""
    return getattr(param, "allreduce", True) is False


def split_params_into_different_moe_groups_for_optimizer(param_groups) -> List[Dict]:
    """One group dict (or a list of them) → the dense group(s), each followed
    by the expert group split from it."""
    if isinstance(param_groups, dict):
        param_groups = [param_groups]
    out: List[Dict] = []
    for i, group in enumerate(param_groups):
        base = {k: v for k, v in group.items() if k != "params"}
        params = list(group["params"])
        dense_params = [p for p in params if not is_moe_param(p)]
        moe_params = [p for p in params if is_moe_param(p)]
        if dense_params:
            out.append(dict(base, params=dense_params))
        if moe_params:
            moe = dict(base, params=moe_params, moe=True)
            moe["name"] = f"{base['name']}_moe" if base.get("name") else f"moe_group_{i}"
            out.append(moe)
    return out


def moe_groups():
    """``(gate, expert, expert-data, sequence)`` ``RankGroup`` objects of
    this rank (the gate's group over ``groups.SEQ_DATA_PARALLEL_AXES``, its
    sequence ranks the minor ones), or four Nones in a world of one rank
    (or with no mesh)."""
    if not groups.mesh_is_initialized() or groups.get_mesh().size == 1:
        return None, None, None, None
    return (groups.get_group(groups.SEQ_DATA_PARALLEL_AXES), groups.get_group(groups.EXPERT_AXIS),
            groups.get_group(groups.EXPERT_ZERO_AXES), groups.get_group(groups.SEQ_AXIS))
