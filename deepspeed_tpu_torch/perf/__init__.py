"""Predicted-vs-observed performance on the card.

Port of the part of ``deepspeed_tpu/perf`` that the serving path runs:

- :mod:`~deepspeed_tpu_torch.perf.chip_specs` — per-card peak specs (the
  H100 first, and a ``cpu-host`` row so that tests price both packages
  alike);
- :mod:`~deepspeed_tpu_torch.perf.observed` — the ledger that joins every
  engine dispatch's observed seconds against the analytic roofline price.

The JAX package's HLO budgets, ``hlo_stats`` and ``roofline`` read what XLA
reports about a lowered program; they are XLA-specific and are ROADMAP A9.
"""

from deepspeed_tpu_torch.perf import chip_specs, observed

__all__ = ["chip_specs", "observed"]
