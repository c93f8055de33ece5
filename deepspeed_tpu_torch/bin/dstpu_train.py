"""Training-job supervisor: restart on a crash, resume from the latest
good checkpoint.

    python -m deepspeed_tpu_torch.bin.dstpu_train --ckpt-dir /ckpt/run7 --max-crashes 5 -- \\
        python train.py

Port of ``bin/dstpu_train``, with its arguments. One training command (one
that resumes itself from ``DSTPU_CKPT_DIR`` through
``engine.load_checkpoint``) runs under a
:class:`~deepspeed_tpu_torch.elasticity.TrainSupervisor`:

- a crash restarts the command after a bounded-jitter exponential backoff
  (the fleet's ``backoff_delay``), exporting ``DSTPU_RESTART_COUNT`` so the
  chaos injector's one-shot kill points stay one-shot;
- ``--max-crashes`` crashes inside ``--crash-window`` seconds quarantine the
  job (it gives up with the child's exit code);
- SIGTERM or SIGINT is forwarded to the child as SIGTERM (its preemption
  handler writes a final checkpoint), which gets ``--grace`` seconds;
- a child exiting 143 (``TrainingPreempted``) exits the supervisor with 143
  unless ``--restart-on-preempt``.

``--procs N`` (N > 1) supervises a gang of N processes, one a rank, through
the elastic agent (``elasticity/elastic_agent.py``): a worker's death or
hang tears the gang down, and it is relaunched at an elasticity-valid world
size with the same backoff.

``--device`` (``cuda`` by default) is the device the children train on,
exported to them as ``DSTPU_DEVICE``; without a GPU the supervisor refuses
to start unless ``--device cpu`` is given.
"""

import argparse
import os
import sys


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m deepspeed_tpu_torch.bin.dstpu_train",
                                description="supervise a training command: restart on crash with backoff, resume "
                                            "from the latest good checkpoint")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory exported as DSTPU_CKPT_DIR (the child resumes from its latest good tag)")
    p.add_argument("--procs", type=int, default=1, help=">1 = multi-process supervision via the elastic agent")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: exported to the children as DSTPU_DEVICE")
    p.add_argument("--max-crashes", type=int, default=3)
    p.add_argument("--crash-window", type=float, default=300.0)
    p.add_argument("--backoff-base", type=float, default=0.5)
    p.add_argument("--backoff-cap", type=float, default=30.0)
    p.add_argument("--backoff-multiplier", type=float, default=2.0)
    p.add_argument("--jitter", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grace", type=float, default=30.0,
                   help="seconds a SIGTERMed child gets to commit its final checkpoint before SIGKILL")
    p.add_argument("--restart-on-preempt", action="store_true",
                   help="restart after a preemption-safe exit (code 143) instead of exiting with it")
    p.add_argument("--gang-dir", default=None,
                   help="(--procs > 1) heartbeat + state dir for the rank watchdog")
    p.add_argument("--hang-timeout", type=float, default=None,
                   help="(--procs > 1) seconds of train-loop heartbeat staleness before a live rank counts as wedged "
                        "and the gang is torn down (default off)")
    p.add_argument("--boot-timeout", type=float, default=None,
                   help="(--procs > 1, with --hang-timeout) seconds a launched rank gets to produce its first "
                        "heartbeat (default max(10x hang-timeout, 120))")
    p.add_argument("--term-grace", type=float, default=5.0,
                   help="(--procs > 1) teardown grace between gang SIGTERM and SIGKILL escalation")
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if "--" in argv:
        split = argv.index("--")
        opts, cmd = argv[:split], argv[split + 1:]
    else:
        opts, cmd = [], argv
    p = parser()
    args = p.parse_args(opts)
    if not cmd:
        p.error("no training command given (usage: dstpu_train [opts] -- cmd ...)")

    from deepspeed_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)  # no GPU and no --device cpu: refuse here
    env = dict(os.environ)
    env["DSTPU_DEVICE"] = device.type
    if args.ckpt_dir:
        env["DSTPU_CKPT_DIR"] = os.path.abspath(args.ckpt_dir)

    if args.procs > 1:
        print("dstpu_train: --procs > 1 supervises through the elastic agent: --grace/--restart-on-preempt/"
              "--backoff-multiplier do not apply; a rank exiting 143 drains the gang (agent exits 143, not a "
              "crash); --max-crashes in --crash-window at one world size shrinks the next launch to a smaller "
              "valid world", file=sys.stderr)
        from deepspeed_tpu_torch.elasticity import DSElasticAgent, ElasticAgentError
        # the restart allowance scales with the shrink ladder (the budget a
        # world, one rung a shrink); --max-crashes 0 fails on the first crash
        agent = DSElasticAgent(cmd, num_processes=args.procs, env=env, max_restarts=args.max_crashes * args.procs,
                               restart_backoff_base_s=args.backoff_base, restart_backoff_cap_s=args.backoff_cap,
                               restart_jitter_frac=args.jitter, seed=args.seed, gang_dir=args.gang_dir,
                               hang_timeout_s=args.hang_timeout, boot_timeout_s=args.boot_timeout,
                               term_grace_s=args.term_grace, max_crashes=args.max_crashes,
                               crash_window_s=args.crash_window)
        try:
            rc = agent.run()
        except ElasticAgentError as e:
            print(f"dstpu_train: exit rc=1 restarts={agent.restart_count} ({e})")
            return 1
        print(f"dstpu_train: exit rc={rc} restarts={agent.restart_count} world={agent.world}")
        return rc

    from deepspeed_tpu_torch.elasticity import TrainSupervisor
    sup = TrainSupervisor(cmd, env=env, ckpt_dir=args.ckpt_dir, max_crashes=args.max_crashes,
                          crash_window_s=args.crash_window, backoff_base_s=args.backoff_base,
                          backoff_cap_s=args.backoff_cap, backoff_multiplier=args.backoff_multiplier,
                          jitter_frac=args.jitter, seed=args.seed, grace_s=args.grace,
                          restart_on_preempt=args.restart_on_preempt)
    rc = sup.run()
    print(f"dstpu_train: exit rc={rc} restarts={sup.restarts}{' quarantined' if sup.quarantined else ''}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
