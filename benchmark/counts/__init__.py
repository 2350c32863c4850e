"""Operation and byte arithmetic of the benchmark: model FLOPs for the
``mfu.*`` metrics (``flops.py``), the MBConv block's least time for its
roofline share (``mbconv.py``), and the card's published peaks
(``peaks.json``)."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())

# a configuration's stated precision -> the peak its FLOPs are held to
PEAK_OF_PRECISION = {"f32": "f32_flops_per_s", "bf16": "bf16_flops_per_s"}
