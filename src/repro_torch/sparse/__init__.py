from repro_torch.sparse.delta import SparseDelta
from repro_torch.sparse.formats import COO, CSR, CSC, coo_from_dense, csr_from_coo, csc_from_coo, dense_from_coo
from repro_torch.sparse.generate import PAPER_SUITE, MatrixSpec, generate, generate_suite
from repro_torch.sparse.bell import BellMatrix, BellShard, pack_bell, tile_counts
