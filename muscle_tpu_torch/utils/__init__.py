from muscle_tpu_torch.utils.logging import Logger, MetricLogger
from muscle_tpu_torch.utils.metrics import topk_accuracy
from muscle_tpu_torch.utils.timers import AverageMeter, Timer, profile_trace
from muscle_tpu_torch.utils.train_vis import TrainVisualizer

__all__ = ["AverageMeter", "Logger", "MetricLogger", "Timer", "TrainVisualizer",
           "profile_trace", "topk_accuracy"]
