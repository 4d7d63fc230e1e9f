from repro_torch.data.graphs import (  # noqa: F401
    rmat_graph, erdos_renyi_graph, road_grid_graph, graph500_graph,
    GRAPH_SUITE, make_graph,
)
from repro_torch.data.pipeline import PipelineState, TokenPipeline  # noqa: F401
