"""io of hugectr_tpu_torch: the file layer of snapshots and weight files
(counterpart of hugectr_tpu/io)."""
