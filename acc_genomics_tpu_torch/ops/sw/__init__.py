from acc_genomics_tpu_torch.ops.sw.kernel import (  # noqa: F401
    LAUNCHES,
    sw_fill,
    sw_walk,
)
