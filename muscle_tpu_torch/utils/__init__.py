from muscle_tpu_torch.utils.logging import Logger, MetricLogger
from muscle_tpu_torch.utils.metrics import topk_accuracy
from muscle_tpu_torch.utils.timers import AverageMeter, Timer, recording, span
from muscle_tpu_torch.utils.train_vis import TrainVisualizer
from muscle_tpu_torch.utils.visualize import jet_colormap, show_cam_on_image

__all__ = ["AverageMeter", "Logger", "MetricLogger", "Timer", "TrainVisualizer",
           "jet_colormap", "recording", "show_cam_on_image", "span", "topk_accuracy"]
