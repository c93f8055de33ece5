"""Offline checkpoint -> one f32 state dict (command line).

Port of ``deepspeed_tpu/utils/zero_to_fp32.py``: put a checkpoint's masters
back together, whatever world size and ZeRO stage wrote them (the rank
files of ``runtime/checkpoint_engine`` joined along their chunk dimension;
a tag saved across model, sequence or expert ranks holds them whole
already, as a world-1 tag does), and export them flat:

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <output_file> [--tag TAG]

The output is an ``.npz`` with one f32 array per ``state_dict`` name of the
port's model (``layers.0.mlp.up_proj.weight``, a ``Linear`` weight as
``[out, in]``), loadable with ``numpy.load`` anywhere. No engine is built and
no device is used.
"""

import argparse
import os
import sys

import numpy as np


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """``{name: np.float32 array}`` of the checkpoint's masters (the tag in
    ``latest`` when none is given), verified against its manifest first."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import (LATEST_FILE, CheckpointCorruptionError,
                                                                      read_state, verify_checkpoint)

    if tag is None:
        latest = os.path.join(checkpoint_dir, LATEST_FILE)
        if not os.path.isfile(latest):
            raise FileNotFoundError(f"no tag given and no {latest}")
        with open(latest) as f:
            tag = f.read().strip()
    path = os.path.join(os.path.abspath(checkpoint_dir), str(tag))
    if not os.path.isdir(os.path.join(path, "state")):
        raise FileNotFoundError(f"checkpoint state not found under {path}")
    status, detail = verify_checkpoint(path)
    if status != "good":
        raise CheckpointCorruptionError(f"checkpoint {path} is {status.upper()}: {detail}")
    params = read_state(path)["params"]
    return {name: t.float().numpy() for name, t in params.items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file, tag=None):
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
    np.savez(output_file, **sd)
    total = sum(v.size for v in sd.values())
    print(f"wrote {len(sd)} tensors ({total:,} fp32 params) to {output_file}")
    return output_file


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.utils.zero_to_fp32",
                                     description="put a checkpoint's f32 masters together into one flat .npz")
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_file")
    parser.add_argument("--tag", default=None, help="checkpoint tag (default: the 'latest' file)")
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
