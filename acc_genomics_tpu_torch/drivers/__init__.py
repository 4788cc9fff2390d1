"""Oracle-checked drivers of the port's engines, the counterparts of the
repository's ``drivers/*_driver.py``.  Each runs as ``python -m
acc_genomics_tpu_torch.drivers.<name> [flags] [--device cuda|cpu]``,
exposes ``main(argv) -> int`` and returns non-zero on any mismatch
against the oracles or the native host engines."""
