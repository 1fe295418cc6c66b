from pandepth_jax.stats.tables import output_prefix, write_tables, \
    write_site_depth

__all__ = ["output_prefix", "write_tables", "write_site_depth"]
