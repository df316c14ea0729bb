"""The frozen arithmetic against values worked by hand."""

from __future__ import annotations

from portbench import spec, yardstick
from portbench.kinds import alexnet, resnet


def test_conv_macs():
    # 8x8 input, 3x3 stride 1 pad 1, 2 -> 4 channels: 8*8*4*2*9.
    assert yardstick.conv_macs(8, 2, 4, 3, 1, 1) == (4608, 8)
    # 7x7/2 pad 3 on 32: side 16.
    assert yardstick.conv_macs(32, 3, 64, 7, 2, 3)[1] == 16


def test_small_resnet():
    # 32x32x3, one stage of one block at width 16 (inner 4), 10 classes:
    # stem 16*16*64*3*49; pool -> 8x8; block: 1x1 64->4, 3x3 4->4,
    # 1x1 4->16, projection 1x1 64->16, all at 8x8; head 16*10.
    stem = 16 * 16 * 64 * 3 * 49
    block = 64 * (4 * 64 + 4 * 4 * 9 + 16 * 4 + 16 * 64)
    assert resnet.resnet_forward_macs(32, [1], [16], 10) == (
        stem + block + 160)


def test_small_alexnet():
    # 16x16x3, one conv 3->8 k3 s1 p1, pool after it (16 -> 7), one dense
    # of 5, 2 classes.
    conv = 16 * 16 * 8 * 3 * 9
    dense = 8 * 7 * 7 * 5 + 5 * 2
    assert alexnet.alexnet_forward_macs(
        16, [[3, 8, 3, 1, 1]], [0], [5], 2) == conv + dense


def test_published_models():
    r = spec.load_json(f"{spec.HERE}/configs/resnet50-imagenet-bf16.json")
    a = spec.load_json(f"{spec.HERE}/configs/alexnet-imagenet-bf16.json")
    # 4.09 G multiply-adds for ResNet-50 and 0.71 G for AlexNet at 224.
    assert abs(yardstick.forward_macs(r) / 4.089e9 - 1) < 0.01
    assert abs(yardstick.forward_macs(a) / 0.7145e9 - 1) < 0.01
    assert yardstick.step_flops(r, 32) == 6.0 * yardstick.forward_macs(r) * 32


def test_selection_bytes_and_peaks():
    assert yardstick.k_for_density(1000, 0.001) == 1
    assert yardstick.k_for_density(25557032, 0.001) == 25558
    assert yardstick.select_bytes(1000, 1) == 12008
    assert yardstick.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989.4e12
    assert yardstick.peak_flops("NVIDIA H100 PCIe", "bfloat16") == 756.5e12
    assert yardstick.peak_bytes("NVIDIA H100 80GB HBM3") == 3.35e12
    assert yardstick.peak_flops("NVIDIA A100", "bfloat16") is None
