from muscle_tpu_torch.models.efficientnet import EfficientNet, MBConvBlock, efficientnet_config
from muscle_tpu_torch.models.irn import EdgeDisplacement, IRNNet
from muscle_tpu_torch.models.muscle import (
    PYRAMID_TABLE,
    MuSCLe,
    calibrate_seg_head,
    classifier_as,
    init_weights,
)
from muscle_tpu_torch.models.resnet50 import ResNet50

__all__ = ["EdgeDisplacement", "EfficientNet", "IRNNet", "MBConvBlock", "MuSCLe",
           "PYRAMID_TABLE", "ResNet50", "calibrate_seg_head", "classifier_as",
           "efficientnet_config", "init_weights"]
