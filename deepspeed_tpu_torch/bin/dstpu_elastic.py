"""Inspect an elasticity config.

    python -m deepspeed_tpu_torch.bin.dstpu_elastic -c ds_config.json [-w WORLD]

Port of ``bin/dstpu_elastic``: the elastic batch math (the final batch size,
the valid world sizes and, given a world size, the micro-batch) from
``deepspeed_tpu_torch.elasticity.compute_elastic_config``, so an operator
sees which world sizes a job may land on before launching it.
"""

import argparse
import json
import sys


def main(argv=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.elasticity import compute_elastic_config

    parser = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.bin.dstpu_elastic",
                                     description="elasticity config inspector")
    parser.add_argument("-c", "--config", type=str, required=True, help="engine config json with an 'elasticity' block")
    parser.add_argument("-w", "--world-size", type=int, default=0, help="intended/current world size")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        ds_config = json.load(f)

    print("------------------------------------------")
    print("Elasticity config:")
    print("------------------------------------------")
    print(json.dumps(ds_config["elasticity"], indent=4, sort_keys=True))
    if args.world_size > 0:
        batch, valid_chips, micro = compute_elastic_config(ds_config=ds_config,
                                                           target_deepspeed_version=deepspeed_tpu_torch.__version__,
                                                           world_size=args.world_size, return_microbatch=True)
        print("------------------------------------------")
        print(f"Calculated results for world size {args.world_size}:")
        print("------------------------------------------")
        print(f"final_batch_size .... {batch}")
        print(f"valid_chips ......... {valid_chips}")
        print(f"micro_batch_size .... {micro}")
    else:
        batch, valid_chips = compute_elastic_config(ds_config=ds_config,
                                                    target_deepspeed_version=deepspeed_tpu_torch.__version__)
        print("------------------------------------------")
        print("Calculated results:")
        print("------------------------------------------")
        print(f"final_batch_size .... {batch}")
        print(f"valid_chips ......... {valid_chips}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
