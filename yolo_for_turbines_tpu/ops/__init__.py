from .iou import iou_aligned, calc_iou
from .decode import (
    cells_to_boxes,
    decode_scale,
    decode_all_scales,
    decode_raw_scale,
    decode_raw_all,
)
from .nms import (
    batched_nms,
    default_use_pallas_nms,
    nms_single,
    nms_to_list,
    non_max_suppression,
)
from .map import calc_map, calc_map_device
