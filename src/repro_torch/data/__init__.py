from .partition import dirichlet_partition, heterogeneity_stats
from .synthetic import (ClientDataset, iterate_client_batches,
                        make_classification, make_lm_domains)

__all__ = ["ClientDataset", "make_classification", "make_lm_domains",
           "iterate_client_batches", "dirichlet_partition",
           "heterogeneity_stats"]
