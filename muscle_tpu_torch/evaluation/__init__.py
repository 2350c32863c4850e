from muscle_tpu_torch.evaluation.miou import (
    VOC_CATEGORIES,
    confusion_matrix,
    evaluate_folder,
    iou_from_confusion,
    threshold_sweep,
)

__all__ = ["VOC_CATEGORIES", "confusion_matrix", "evaluate_folder", "iou_from_confusion",
           "threshold_sweep"]
