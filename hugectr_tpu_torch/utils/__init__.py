"""utils of hugectr_tpu_torch (counterpart of hugectr_tpu/utils)."""
