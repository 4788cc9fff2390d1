from acc_genomics_tpu_torch.ops.extend.kernel import (  # noqa: F401
    KEYS,
    LAUNCHES,
    sw_extend,
    sw_extend_rows,
)
