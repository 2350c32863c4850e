from muscle_tpu_torch.models.efficientnet import EfficientNet, MBConvBlock, efficientnet_config
from muscle_tpu_torch.models.muscle import PYRAMID_TABLE, MuSCLe, init_weights

__all__ = ["EfficientNet", "MBConvBlock", "MuSCLe", "PYRAMID_TABLE", "efficientnet_config",
           "init_weights"]
