from muscle_tpu_torch.ops.random_walk import (
    PathIndex,
    affinity_to_dense,
    edge_to_affinity,
    propagate_to_edge,
    propagate_to_edge_sharded,
    propagate_to_edge_stencil,
    to_transition_matrix,
)
from muscle_tpu_torch.ops.crf import mean_field_crf
from muscle_tpu_torch.ops.affinity_labels import affinity_labels_from_indices

__all__ = ["PathIndex", "affinity_labels_from_indices", "affinity_to_dense", "edge_to_affinity",
           "mean_field_crf", "propagate_to_edge", "propagate_to_edge_sharded",
           "propagate_to_edge_stencil", "to_transition_matrix"]
