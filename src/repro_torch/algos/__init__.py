from repro_torch.algos.bfs import bfs, bfs_batch  # noqa: F401
from repro_torch.algos.sssp import sssp, sssp_batch  # noqa: F401
from repro_torch.algos.cc import connected_components  # noqa: F401
from repro_torch.algos.widest import (widest_path,  # noqa: F401
                                     reference_widest)
