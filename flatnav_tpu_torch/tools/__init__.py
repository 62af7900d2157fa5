"""Command-line entries of the port: `python -m flatnav_tpu_torch.tools.construct` builds and saves an index, `python -m flatnav_tpu_torch.tools.query` loads one and sweeps ef_search."""
