from muscle_tpu_torch.core.cam_norm import (
    attach_bg_channel,
    cam_maxnorm,
    cam_maxnorm_with_bg,
    cam_softmaxnorm,
    gap2d,
    gap2d_pos,
)
from muscle_tpu_torch.core.resize import resize_bilinear, resize_to
from muscle_tpu_torch.core.sobel import orient_quantize, sobel_edges, sobel_kernel
from muscle_tpu_torch.core.palette import voc_color_map

__all__ = ["attach_bg_channel", "cam_maxnorm", "cam_maxnorm_with_bg", "cam_softmaxnorm", "gap2d",
           "gap2d_pos", "orient_quantize", "resize_bilinear", "resize_to", "sobel_edges",
           "sobel_kernel", "voc_color_map"]
