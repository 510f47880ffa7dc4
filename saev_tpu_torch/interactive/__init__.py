"""Interactive exploration tools (the counterpart of saev_tpu/interactive):
static HTML/PNG reports in place of the reference's marimo notebooks, from
the same artifacts, importable as plain libraries for notebook use. They run
on the host; pandas is imported where a parquet file is read.
"""
