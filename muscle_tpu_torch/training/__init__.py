from muscle_tpu_torch.training.irn import (
    IRNTrainConfig,
    irn_losses,
    irn_train_step,
    make_irn_sgd,
)
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
from muscle_tpu_torch.training.seg import (
    SegConfig,
    cross_entropy,
    seg_term_grad_norms,
    seg_train_step,
)
from muscle_tpu_torch.training.state import (
    batch_stats_train,
    make_adam,
    minimize,
    restore_checkpoint,
    save_checkpoint,
    set_learning_rate,
)

__all__ = ["IRNTrainConfig", "MCLConfig", "ReduceLROnPlateau", "SegConfig", "batch_stats_train",
           "cross_entropy", "decode_image", "irn_losses", "irn_train_step", "make_adam", "make_irn_sgd",
           "mcl_term_grad_norms", "mcl_train_step", "mcl_views_step", "minimize",
           "norm_on_device", "poly_schedule", "restore_checkpoint", "save_checkpoint",
           "seg_term_grad_norms", "seg_train_step", "set_learning_rate", "term_liveness"]
