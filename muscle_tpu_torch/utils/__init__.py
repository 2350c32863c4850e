from muscle_tpu_torch.utils.logging import Logger, MetricLogger
from muscle_tpu_torch.utils.metrics import topk_accuracy
from muscle_tpu_torch.utils.timers import AverageMeter, Timer, profile_trace
from muscle_tpu_torch.utils.train_vis import TrainVisualizer
from muscle_tpu_torch.utils.visualize import jet_colormap, show_cam_on_image

__all__ = ["AverageMeter", "Logger", "MetricLogger", "Timer", "TrainVisualizer",
           "jet_colormap", "profile_trace", "show_cam_on_image", "topk_accuracy"]
