from muscle_tpu_torch.models.efficientnet import EfficientNet, MBConvBlock, efficientnet_config
from muscle_tpu_torch.models.irn import EdgeDisplacement
from muscle_tpu_torch.models.muscle import PYRAMID_TABLE, MuSCLe, init_weights
from muscle_tpu_torch.models.resnet50 import ResNet50

__all__ = ["EdgeDisplacement", "EfficientNet", "MBConvBlock", "MuSCLe", "PYRAMID_TABLE",
           "ResNet50", "efficientnet_config", "init_weights"]
