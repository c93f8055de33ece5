#!/usr/bin/env bash
# Run chip_smoke.py from two source trees on one GPU, in the order parent,
# change, change, parent, so that the card's drift between runs shows as a
# difference within one tree rather than between the trees.
#
#   tools/chip_smoke_compare.sh PARENT_DIR CHANGE_DIR [flash|paged|sparse|kernels|main|prefix|spec|observe|fleet|features|MODE,MODE...]
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
# with "prefix", the main path (for its logit errors, the teacher-forced
# tolerance) and the prefix phase (run_prefix_path: TTFT cold and hot, B1's
# launches in hot puts, handoff and disk-tier rates); with "spec", the main
# path and the speculative phase (run_spec_path: served TTFT, ITL and tokens/s
# with speculation off, prompt lookup through B1 and the gather branch, and
# an oracle drafter; acceptance, verify dispatches, B1 launches, the
# full-width verify_tree's time and peak memory, the learned drafter's host
# ms a draft); with "observe", the main path and the observe phase
# (run_observe_path: a traced decode put's per-layer split and tracing
# overhead, the profiled puts' phases against device time and host wall, the
# prefill put's observed seconds, the cost plane's totals and the SLO bursts);
# with "fleet", the main path and the fleet phase (run_fleet_path: the
# disaggregated burst's TTFT, ITL, served tokens/s, frame bytes and export /
# import GB/s, the router's host ms a request, the time from a decode
# replica's death to the next token, the steals, the peer fetch, the process
# replica's spawn and restart seconds); with "features", the train features phase (run_train_features_path:
# tokens/s at each curriculum length, prefetch and telemetry step times, the
# compression transforms' ulps, the eigenvalue leg); modes joined by commas
# run each. The exit code
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
if modes & {"main", "prefix", "spec", "observe", "fleet"}:
    params = c.main_params(dev)
    main = c.run_main_path(dev, params)
if "main" in modes:
    r = main
    print(json.dumps(dict({k: r[k] for k in ("prefill_tokens_per_s", "decode_tokens_per_s", "ms_per_decode_step",
                                             "paged_attention_launches")},
                          generate_wall_s=[x["wall_s"] for x in r["runs"]])))
if "prefix" in modes:
    r = c.run_prefix_path(dev, params, main)
    h, d = r["handoff"], r["disk_tier"]["round_trip"]
    print(json.dumps(dict({k: r[k] for k in ("ttft_cold_s", "ttft_staggered_p50_s", "ttft_staggered_p99_s",
                                             "ttft_burst_p50_s", "ttft_burst_p99_s", "prefill_tokens_avoided",
                                             "staggered_tokens_per_s", "burst_tokens_per_s", "b1_launches_hot_puts",
                                             "device_busy_share_profiled_burst")},
                          export_ms=h["export_ms"], import_ms=h["import_ms"], claim_http_ms=h["claim_http_ms"],
                          demote_gb_per_s=d["demote_gb_per_s"], promote_gb_per_s=d["promote_gb_per_s"])))
if "spec" in modes:
    r = c.run_spec_path(dev, params, main)
    legs = ("spec_off", "lookup_b1", "lookup_gather", "oracle")
    keys = ("ttft_p50_s", "itl_p50_s", "served_tokens_per_s", "decode_ticks", "verify_dispatches", "acceptance",
            "b1_launches")
    print(json.dumps(dict({leg: {k: r[leg][k] for k in keys} for leg in legs},
                          verify_tree=r["full_width_verify_tree"],
                          learned_host_ms_per_draft=r["learned"]["learned"]["host_ms_per_draft"])))
if "observe" in modes:
    r = c.run_observe_path(dev, params, main)
    t = r["tracer"]
    print(json.dumps(dict(split=t["decode_put_split"], profiled_puts=t["profiled_puts"],
                          prefill_put=t["prefill_put_dispatch_timing"], cost_totals=r["cost"]["totals"],
                          pricebook_vs_card=r["pricebook_vs_card"],
                          slo={k: {kk: r[k][kk] for kk in ("max_stage", "breached", "itl_p50_s")}
                               for k in ("slo", "slo_control")})))
if "fleet" in modes:
    r = c.run_fleet_path(dev, params, main)
    d, e = r["disaggregated"], r["process_replica"]
    print(json.dumps(dict({k: d[k] for k in ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
                                             "served_tokens_per_s", "router_host_ms", "b1_launches")},
                          frame_bytes=sum(x["frame_bytes"] for x in d["exports"]),
                          export_gb_per_s=[x["gb_per_s"] for x in d["exports"]],
                          import_gb_per_s=[x["gb_per_s"] for x in d["imports"]],
                          death_to_next_token_s=r["death"]["death_to_next_token_s"],
                          steal=r["steal"]["router"], peer_fetch_ms=r["peer_fetch"]["fetch_ms"],
                          spawn_to_ready_s=e["spawn_to_ready_s"], kill_to_ready_s=e["kill_to_ready_s"],
                          seconds=r["seconds"])))
if "features" in modes:
    r = c.run_train_features_path(dev)
    p, t, e = r["loaders"]["prefetch"], r["loaders"]["telemetry"], r["eigenvalue"]
    print(json.dumps(dict(curriculum_tokens_per_s=[(s["predicted"], s["tokens_per_s"]) for s in r["curriculum"]["curriculum"]],
                          control_tokens_per_s=[s["tokens_per_s"] for s in r["curriculum"]["control"]],
                          prefetch_s=(p["median_s_prefetch"], p["median_s_direct"]),
                          telemetry_s=(t["median_s_on"], t["median_s_off"]),
                          compression_ulps=[a["max_ulps"] for a in r["compression"]["applied"]],
                          eigen_iters=e["iters"], hvp_vs_fd=e["hvp_vs_central_difference"], seconds=r["seconds"])))
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
