from repro_torch.algos.bfs import bfs  # noqa: F401
from repro_torch.algos.sssp import sssp  # noqa: F401
