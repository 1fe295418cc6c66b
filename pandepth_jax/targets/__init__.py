from pandepth_jax.targets.model import TargetSet, GeneAccumulator
from pandepth_jax.targets.parse import (
    detect_gff_mode, detect_bed_mode, parse_targets)
from pandepth_jax.targets.windows import synthesize_default_targets

__all__ = [
    "TargetSet", "GeneAccumulator", "detect_gff_mode", "detect_bed_mode",
    "parse_targets", "synthesize_default_targets",
]
