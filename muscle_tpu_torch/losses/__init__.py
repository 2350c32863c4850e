from muscle_tpu_torch.losses.beacon import FieldLossConfig, field_loss
from muscle_tpu_torch.losses.classification import (
    er_topk_loss,
    focal_loss,
    lsep_loss,
    soft_margin_loss,
)
from muscle_tpu_torch.losses.contrastive import image_level_contrast, info_nce, pixpro_loss
from muscle_tpu_torch.losses.emd import (
    crop_weight_vector,
    draw_crop_fractions,
    dynamic_matching_emd,
    pairwise_cosine_cost,
    sinkhorn_emd,
    static_matching_emd,
)
from muscle_tpu_torch.losses.edge_support import (
    box_filter,
    field_masks,
    grayscale_edge,
    straight_through_argmax,
    unit_vectors,
)

__all__ = ["FieldLossConfig", "box_filter", "crop_weight_vector", "draw_crop_fractions",
           "dynamic_matching_emd", "er_topk_loss", "field_loss", "field_masks", "focal_loss",
           "grayscale_edge", "image_level_contrast", "info_nce", "lsep_loss",
           "pairwise_cosine_cost", "pixpro_loss", "sinkhorn_emd", "soft_margin_loss",
           "static_matching_emd", "straight_through_argmax", "unit_vectors"]
