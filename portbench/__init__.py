"""The benchmark of ``fast_tffm_tpu_torch`` (see ``README.md``)."""
