from repro_torch.kernels.gmm.ops import VARIANTS, gmm, gmm_variant, grouped_matmul, plan_groups
from repro_torch.kernels.gmm.ref import gmm_plain

__all__ = ["VARIANTS", "gmm", "gmm_plain", "gmm_variant", "grouped_matmul", "plan_groups"]
