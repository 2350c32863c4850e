from muscle_tpu_torch.inference.cam import CamTTAEngine

__all__ = ["CamTTAEngine"]
