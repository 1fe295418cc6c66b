from pandepth_jax.utils.log import RunStats, phase, set_verbose

__all__ = ["RunStats", "phase", "set_verbose"]
