"""The benchmark's operation and byte counts against hand counts and
against ``FlopCounterMode`` on the program's own model."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.counts import PEAKS, flops, mbconv  # noqa: E402

B3 = json.loads((ROOT / "benchmark" / "configs" / "muscle_b3.json").read_text())
B7 = json.loads((ROOT / "benchmark" / "configs" / "muscle_b7.json").read_text())


def test_one_block_call_by_hand():
    # 2 versions of a 4 x 6 map, Cin 8 -> Cmid 48 (expand 6) -> Cout 8, k 3, Csq 2
    px = 2 * 4 * 6
    nbytes, products, depthwise = mbconv.call_work(px, 8, 48, 2, 8, 3, True)
    weights = 8 * 48 + 9 * 48 + 2 * 48 * 2 + 48 * 8     # w_exp, w_dw, SE pair, w_proj
    vectors = 2 * 48 + 2 * 48 + 2 + 48 + 2 * 8          # s0 b0, s1 b1, b_se_r, b_se_e, s2 b2
    assert nbytes == 4 * (px * (8 + 8) + weights + vectors)
    assert products == 2 * px * (8 * 48 + 48 * 8)
    assert depthwise == 2 * px * 9 * 48
    least = mbconv.least_seconds(nbytes, products, depthwise)
    ops = products / PEAKS["tf32_flops_per_s"] + depthwise / PEAKS["f32_flops_per_s"]
    assert least == max(nbytes / PEAKS["hbm_bytes_per_s"], ops)


def test_fused_blocks_are_the_programs():
    """The blocks the count takes are those the program's model fuses:
    stride 1 with at most ``fuse_mbconv`` input channels."""
    from muscle_tpu_torch.models.efficientnet import efficientnet_config

    for config, n in ((B3, 23), (B7, 48)):
        blocks, _ = efficientnet_config(config["backbone"], config["last_pooling"])
        fused = [a for a in blocks if a.stride == 1 and a.input_filters <= config["fuse_mbconv"]]
        got = mbconv.fused_blocks(config)
        assert len(got) == len(fused) == n
        assert [(c[1], c[4], c[5]) for c in got] == [
            (a.input_filters, a.output_filters, a.kernel_size) for a in fused]


def test_batch_least_seconds_sums_the_unpadded_calls():
    one = mbconv.batch_least_seconds(B3, [1.0], [(375, 500)])
    two = mbconv.batch_least_seconds(B3, [1.0], [(375, 500), (375, 500)])
    assert 1.0 < two / one < 2.0  # the weights are read once a call
    assert mbconv.batch_least_seconds(B3, [0.5, 1.0], [(375, 500)]) > one


def test_forward_flops_agree_with_the_programs_model():
    from muscle_tpu_torch.models import MuSCLe

    config = dict(B3, backbone="efficientnet-b1")
    with torch.device("meta"):
        model = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False).eval()
    x = torch.empty((1, 96, 128, 3), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, mode="cam_lowres")
    assert flops.image_flops(config, [1.0], (96, 128)) == 2 * fc.get_total_flops()


def test_conv_backward_counts_groups():
    conv = torch.nn.Conv2d(48, 48, 3, groups=48, padding=1, device="meta")
    x = torch.empty((2, 48, 16, 16), device="meta", requires_grad=True)
    fwd = 2 * 2 * 48 * 16 * 16 * 9
    assert flops._count(lambda: conv(x)) == fwd
    assert flops._count(lambda: conv(x).sum().backward()) == 3 * fwd


@pytest.mark.parametrize("batch", [2, 4])
def test_train_flops_are_per_image(batch):
    config = dict(B3, backbone="efficientnet-b1")
    per = flops.train_image_flops(config, batch, 64)
    assert per == pytest.approx(flops.train_image_flops(config, 2 * batch, 64), rel=1e-3)
