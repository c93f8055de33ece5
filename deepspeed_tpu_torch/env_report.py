"""Environment and checkpoint reports.

Port of one function of ``deepspeed_tpu/env_report.py``:
:func:`checkpoint_report`. The rest of the report and ``bin/dstpu_report``
come with ROADMAP A9.
"""

import json
import os

from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (LATEST_FILE, PREEMPT_MARKER, list_tags,
                                                                  retention_plan, verify_checkpoint)

GREEN_OK = "\033[92m[OKAY]\033[0m"
RED_NO = "\033[93m[NO]\033[0m"


def checkpoint_report(save_dir, keep_last_k=None):
    """Verify every tag's manifest CRCs under ``save_dir`` and print each
    tag's status (good, torn, corrupt, reference) and whether keep-last-K
    retention keeps it (K from ``keep_last_k``, else the newest manifest's
    recorded ``keep_last_k``). Returns 0 when every tag is good."""
    save_dir = os.path.abspath(save_dir)
    tags = list_tags(save_dir)
    pointed = None
    latest_file = os.path.join(save_dir, LATEST_FILE)
    if os.path.isfile(latest_file):
        with open(latest_file) as f:
            pointed = f.read().strip()

    if keep_last_k is None:
        for entry in tags:  # newest first: the freshest save's config wins
            if entry["manifest"] is not None:
                keep_last_k = entry["manifest"].get("keep_last_k", 0)
                break
    keep, _ = retention_plan(save_dir, keep_last_k or 0)
    survivors = {e["tag"] for e in keep}

    print("-" * 78)
    print(f"checkpoint dir ......... {save_dir}")
    print(f"tags ................... {len(tags)} (latest → {pointed or 'none'}, keep_last_k={keep_last_k or 0})")
    if os.path.isfile(os.path.join(save_dir, PREEMPT_MARKER)):
        with open(os.path.join(save_dir, PREEMPT_MARKER)) as f:
            marker = json.load(f)
        print(f"preemption marker ...... tag {marker.get('tag')} at step {marker.get('global_steps')} "
              f"({marker.get('used_s')}s of {marker.get('grace_s')}s grace)")
    print("-" * 78)
    if not tags:
        print("no checkpoint tags found")
        return 1
    all_good = True
    for entry in tags:
        status, detail = verify_checkpoint(entry["path"])
        all_good &= status == "good"
        manifest = entry["manifest"] or {}
        step = manifest.get("global_steps", "?")
        n_files = len(manifest.get("files", {}))
        n_arrays = len(manifest.get("arrays") or {})
        flags = ["latest"] if entry["tag"] == pointed else []
        flags.append("kept" if entry["tag"] in survivors else "prunable")
        verdict = GREEN_OK if status == "good" else RED_NO
        print(f"{entry['tag']:<28} {verdict} {status:<9} step={step:<8} files={n_files:<4} arrays={n_arrays:<4} "
              f"[{', '.join(flags)}]")
        if status != "good":
            print(f"{'':<28}   ↳ {detail}")
    print("-" * 78)
    print("verdict ................ " + (GREEN_OK + " all tags verified" if all_good else
                                         RED_NO + " bad tags present (load falls back to the newest good one)"))
    return 0 if all_good else 1
