"""Per-card peak specs for the roofline price.

Port of ``deepspeed_tpu/perf/chip_specs.py`` with the port's own table: the
NVIDIA H100 SXM5 80 GB (``nvidia-smi`` names it ``NVIDIA H100 80GB HBM3``) at
its data-sheet figures, dense bf16 989 TFLOP/s and HBM3 3.35 TB/s, both at
the full 700 W power limit; and the ``cpu-host`` placeholder row, whose
numbers mean nothing about any device and exist so that tests price both
packages alike. The H100 is the default.
"""

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float  # dense bf16 FLOP/s per card
    hbm_bytes_per_s: float  # HBM bandwidth per card
    hbm_bytes: float  # HBM capacity per card
    ici_bytes_per_s: float  # aggregate card-to-card interconnect bandwidth
    notes: str = ""


CHIP_SPECS: Dict[str, ChipSpec] = {
    "h100": ChipSpec("h100", peak_bf16_flops=989e12, hbm_bytes_per_s=3.35e12, hbm_bytes=80e9,
                     ici_bytes_per_s=450e9,
                     notes="H100 SXM5 80 GB data sheet at 700 W; NVLink 900 GB/s counted "
                     "one-way, unused by the one-card serving path"),
    # CPU smoke entry so roofline math is exercisable in tests without
    # pretending the numbers mean anything about a device
    "cpu-host": ChipSpec("cpu-host", peak_bf16_flops=1e12, hbm_bytes_per_s=100e9, hbm_bytes=64 * 2**30,
                         ici_bytes_per_s=10e9, notes="placeholder host spec for tests"),
}

DEFAULT_CHIP = "h100"


def get_chip_spec(name: str = DEFAULT_CHIP) -> ChipSpec:
    try:
        return CHIP_SPECS[name]
    except KeyError:
        raise KeyError(f"unknown chip {name!r}; known: {sorted(CHIP_SPECS)}") from None
