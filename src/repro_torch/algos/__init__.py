from repro_torch.algos.bfs import bfs  # noqa: F401
from repro_torch.algos.sssp import sssp  # noqa: F401
from repro_torch.algos.cc import connected_components  # noqa: F401
from repro_torch.algos.widest import (widest_path,  # noqa: F401
                                     reference_widest)
