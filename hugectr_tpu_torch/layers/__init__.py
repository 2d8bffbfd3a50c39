"""layers of hugectr_tpu_torch (see the package docstring)."""
