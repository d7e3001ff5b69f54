from .partition import dirichlet_partition, heterogeneity_stats
from .synthetic import ClientDataset, make_classification

__all__ = ["ClientDataset", "make_classification", "dirichlet_partition",
           "heterogeneity_stats"]
