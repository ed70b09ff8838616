from repro_torch.graphs.formats import (Graph, GraphStats, coo_to_csr,
                                        coo_to_dense, graph_digest,
                                        pad_edges)
from repro_torch.graphs.generators import (erdos_renyi, from_spec,
                                           path_graph, ring_of_cliques, rmat,
                                           star_graph, uniform_random)

__all__ = [
    "Graph",
    "GraphStats",
    "graph_digest",
    "coo_to_csr",
    "coo_to_dense",
    "pad_edges",
    "erdos_renyi",
    "from_spec",
    "path_graph",
    "ring_of_cliques",
    "rmat",
    "star_graph",
    "uniform_random",
]
