#!/usr/bin/env bash
# Run chip_smoke.py from two source trees on one GPU, in the order parent,
# change, change, parent, so that the card's drift between runs shows as a
# difference within one tree rather than between the trees.
#
#   tools/chip_smoke_compare.sh PARENT_DIR CHANGE_DIR [flash|paged|sparse|kernels|main|MODE,MODE...]
#
# Each run's output goes to chiprun_out/smoke_<i>_<tree>.log and its full
# record to chiprun_out/smoke_<i>_<tree>.json, under the directory the script
# is started from; the script prints each run's exit code and last line. With
# "flash", each run builds the kernels and runs only the flash-attention
# kernel phase (check_flash_attention), printing its errors and kernel times
# per case; with "paged", only the paged-attention kernel phase
# (check_paged_attention); with "sparse", only the block-sparse phase
# (check_block_sparse_attention: B5's checks, the sparse step against f32,
# and B5's times beside its bound, SDPA with the mask and dense B2); with
# "kernels", paged and flash; with "main", only the main path (run_main_path:
# Llama-2-7B through generate, its rates and generate's wall time per run);
# modes joined by commas run each. The exit code
# is the last failing run's, else 0.
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
mode=${3:-all}
out=$(pwd)/chiprun_out
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
phase='
import json, sys, torch, chip_smoke as c
c.builder.build()
dev = torch.device("cuda")
modes = set(sys.argv[1].replace("kernels", "paged,flash").split(","))
if "paged" in modes:
    r = c.check_paged_attention(dev)
    print(json.dumps([{k: x[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}
                      for x in r]))
if "flash" in modes:
    r = c.check_flash_attention(dev)
    print(json.dumps([dict(case=x["case"], err=x["max_abs_err"], **{k: x[k]["ms"] for k in ("fwd", "dkv", "dq")})
                      for x in r]))
if "main" in modes:
    r = c.run_main_path(dev)
    print(json.dumps(dict({k: r[k] for k in ("prefill_tokens_per_s", "decode_tokens_per_s", "ms_per_decode_step",
                                             "paged_attention_launches")},
                          generate_wall_s=[x["wall_s"] for x in r["runs"]])))
if "sparse" in modes:
    r = c.check_block_sparse_attention(dev)
    keys = ("case", "density", "max_abs_err", "tol_use", "ms", "ms_index_order", "ms_sorted_again", "ms_split_steps",
            "bound_ms", "plain_ms", "library_ms", "b2_dense_ms", "fwd_bwd_ms")
    print(json.dumps([{k: x[k] for k in keys if k in x} for x in r["cases"]]))
    print(json.dumps({"scaling": r["scaling"], "b5_profile_ms": [x["profile"]["b5_ms"] for x in r["cases"] if "profile" in x]}))
'
status=0
i=0
for tree in parent change change parent; do
    i=$((i + 1))
    dir=$parent
    [ "$tree" = change ] && dir=$change
    log=$out/smoke_${i}_${tree}.log
    if [ "$mode" != all ]; then
        (cd "$dir" && python3 -c "$phase" "$mode") >"$log" 2>&1
    else
        (cd "$dir" && python3 chip_smoke.py) >"$log" 2>&1
    fi
    rc=$?
    [ -f "$dir/chiprun_out/chip_smoke.json" ] && mv "$dir/chiprun_out/chip_smoke.json" "$out/smoke_${i}_${tree}.json"
    echo "== run $i ($tree): rc=$rc ; $(tail -n 1 "$log")"
    [ "$rc" -ne 0 ] && status=$rc
done
exit "$status"
