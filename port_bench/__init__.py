"""The benchmark of acc_genomics_tpu_torch on one H100 (see README.md)."""
