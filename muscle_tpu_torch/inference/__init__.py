from muscle_tpu_torch.inference.cam import CamTTAEngine
from muscle_tpu_torch.inference.irn import RandomWalkRefiner

__all__ = ["CamTTAEngine", "RandomWalkRefiner"]
