from acc_genomics_tpu_torch.ops.smem.kernel import (  # noqa: F401
    LAUNCHES,
    smem_collect,
)
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex, probe_table  # noqa: F401
