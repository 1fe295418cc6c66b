"""Device engine package.

Importing this package stays jax-free (so the CLI can start file IO
while jax initializes on a background thread — see
``pandepth_jax/boot.py``); the engine attributes load lazily, and the
jax-importing submodules each call ``boot.configure_jax()`` at the top
themselves.
"""

__all__ = ["GenomeLayout", "CoverageEngine", "SegmentStats"]


def __getattr__(name):
    if name == "GenomeLayout":
        from pandepth_jax.device.layout import GenomeLayout
        return GenomeLayout
    if name in ("CoverageEngine", "SegmentStats"):
        from pandepth_jax.device import engine
        return getattr(engine, name)
    raise AttributeError(name)
