"""Multi-chip / multi-host sharding package.

Importing this package stays jax-free (see ``pandepth_jax/boot.py``);
attributes load lazily and the jax-importing submodules call
``boot.configure_jax()`` at the top themselves.
"""

__all__ = ["make_mesh", "sharded_coverage_step"]


def __getattr__(name):
    if name in __all__:
        from pandepth_jax.sharding import mesh
        return getattr(mesh, name)
    raise AttributeError(name)
