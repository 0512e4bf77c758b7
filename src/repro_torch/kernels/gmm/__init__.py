from repro_torch.kernels.gmm.ops import gmm, grouped_matmul, plan_groups
from repro_torch.kernels.gmm.ref import gmm_plain

__all__ = ["gmm", "gmm_plain", "grouped_matmul", "plan_groups"]
