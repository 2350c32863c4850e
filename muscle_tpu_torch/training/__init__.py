from muscle_tpu_torch.training.liveness import term_liveness
from muscle_tpu_torch.training.mcl import (
    MCLConfig,
    decode_image,
    mcl_term_grad_norms,
    mcl_train_step,
    mcl_views_step,
    norm_on_device,
)
from muscle_tpu_torch.training.schedule import ReduceLROnPlateau, poly_schedule
from muscle_tpu_torch.training.state import (
    make_adam,
    minimize,
    restore_checkpoint,
    save_checkpoint,
    set_learning_rate,
)

__all__ = ["MCLConfig", "ReduceLROnPlateau", "decode_image", "make_adam",
           "mcl_term_grad_norms", "mcl_train_step", "mcl_views_step", "minimize",
           "norm_on_device", "poly_schedule", "restore_checkpoint", "save_checkpoint",
           "set_learning_rate", "term_liveness"]
