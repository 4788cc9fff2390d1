from acc_genomics_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from acc_genomics_tpu_torch.parallel.sharded import (  # noqa: F401
    pairhmm_forward_dp,
    pairhmm_forward_dpsp,
    pairhmm_forward_dpsp_from_quals,
)
