from muscle_tpu_torch.data.voc12 import (
    VOC12AffinityDataset,
    VOC12ClsPixDataset,
    VOC12ImageDataset,
    VOC12SegDataset,
    build_cls_labels,
    class_frequency_sample_weights,
    get_img_path,
    load_img_name_list,
    load_label_dict,
    load_label_from_xml,
)
from muscle_tpu_torch.data.transforms import (
    color_jitter,
    color_norm,
    random_crop,
    random_erasing,
    random_resize_long,
    two_views,
)
from muscle_tpu_torch.data.tta import MSF_BUCKETS, msf_batch
from muscle_tpu_torch.data.loader import PrefetchLoader

__all__ = ["MSF_BUCKETS", "PrefetchLoader", "VOC12AffinityDataset", "VOC12ClsPixDataset",
           "VOC12ImageDataset", "VOC12SegDataset", "build_cls_labels",
           "class_frequency_sample_weights", "color_jitter", "color_norm", "get_img_path",
           "load_img_name_list", "load_label_dict", "load_label_from_xml", "msf_batch",
           "random_crop", "random_erasing", "random_resize_long", "two_views"]
