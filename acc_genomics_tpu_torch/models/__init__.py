from acc_genomics_tpu_torch.models.bwa_mem import (  # noqa: F401
    BwaEngines,
    BwaMemDevicePipeline,
    BwaMemSeeding,
    SeedHit,
)
from acc_genomics_tpu_torch.models.haplotype_caller import (  # noqa: F401
    HaplotypeCallerCore,
    HCEngines,
    RegionResult,
)
