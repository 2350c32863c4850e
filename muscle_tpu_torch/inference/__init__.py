from muscle_tpu_torch.inference.cam import CamTTAEngine
from muscle_tpu_torch.inference.irn import RandomWalkRefiner
from muscle_tpu_torch.inference.seg import SegTTAEngine

__all__ = ["CamTTAEngine", "RandomWalkRefiner", "SegTTAEngine"]
