"""The paper's own workload: the PMVC matrix suite (Table 4.2) and the
cluster geometry of the Grid'5000 experiments (f ∈ {2..64} nodes × 16
cores)."""
from repro_torch.sparse.generate import PAPER_SUITE

MATRICES = list(PAPER_SUITE)
NODE_COUNTS = [2, 4, 8, 16, 32, 64]
CORES_PER_NODE = 16
COMBOS = ["NL-HL", "NL-HC", "NC-HL", "NC-HC"]
BLOCK = (16, 16)  # (bm, bn) used by CPU-scale benchmarks
BLOCK_TPU = (128, 128)  # MXU-aligned production tiling
