# The paper's load-balancing strategies and their stepped and fused
# engines, ported to PyTorch (see the package docstring).
from repro_torch.core.graph import (CSRGraph, COOGraph, INF,  # noqa: F401
                                    graph_stats)
from repro_torch.core.engine import (run, run_batch, fixed_point,  # noqa: F401
                                     make_strategy, RunResult, SCHEDULES,
                                     ready, reference_distances)
from repro_torch.core.multi_source import BatchRunResult  # noqa: F401
from repro_torch.core.operators import (EdgeOp, OPERATORS,  # noqa: F401
                                        register_operator, shortest_path,
                                        min_label, widest_path, reach_count)
from repro_torch.core.strategies import (STRATEGIES, FRONTIER_INIT,  # noqa: F401
                                         PRIORITY_SCHEDULE, SHARDABLE,
                                         register, strategy_capabilities)
from repro_torch.core.priority import (DeltaPlan, auto_delta,  # noqa: F401
                                       plan_delta)
from repro_torch.core.node_split import find_mdt, split_graph  # noqa: F401
from repro_torch.core.shard import (ShardedCSRGraph, ShardGroup,  # noqa: F401
                                    ShardInfo, partition, plan_shards,
                                    shard_group)
from repro_torch.core.dist import (PartitionedGraph,  # noqa: F401
                                   distributed_sssp, partition_graph)
from repro_torch.core import balance, costmodel, dist, fused, shard  # noqa: F401
