"""Eval metrics (counterpart of hugectr_tpu/metrics)."""
