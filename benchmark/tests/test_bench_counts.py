"""The benchmark's operation and byte counts against hand counts on a tiny
plan, and its lower-precision roundings."""

import pytest
import torch

from benchmark.harness import counts, train
from benchmark.harness.counts import Conv
from benchmark.reference import sparse3d as sp
from benchmark.reference.nets3d import scn, spvcnn

BF16, F32 = torch.bfloat16, torch.float32


def tiny_plan():
    # one scan, three voxels: (0,0,0), (0,0,1), (1,1,1); every voxel is
    # every other's neighbour, so 9 pairs at level 0; one voxel at level 1
    coords = torch.tensor([[0, 0, 0], [0, 0, 1], [1, 1, 1], [0, 0, 1]])
    sample = torch.zeros(4, dtype=torch.long)
    valid = torch.tensor([True, True, True, False])
    return sp.build_plan(coords, sample, valid, torch.tensor([0]), 2)


def test_level_stats_by_hand():
    plan = tiny_plan()
    assert counts.level_stats(plan) == [(3, 9), (1, 1)]
    assert plan.point_voxel.tolist() == [0, 1, 2, -1]
    # the stride-2 map: the three fine voxels at their places in the parent
    assert sorted(plan.levels[1].down_nbr[0].tolist()) == [-1] * 5 + [0, 1, 2]


def test_k1_and_k2_least_time_by_hand():
    stats = [(3, 9), (1, 1)]
    conv = Conv("subm", 0, 4, 8, BF16, grad_in=False)
    k1_bytes = 2 * (3 * 4 + 27 * 4 * 8 + 3 * 8) + 72 * 3       # 2016
    assert 2 * 9 * 4 * 8 / 989e12 < k1_bytes / 3.35e12         # bytes bound
    assert counts.conv_kernel_least_s([conv], stats, False) == \
        pytest.approx(k1_bytes / 3.35e12)
    dw_bytes = 2 * (3 * 4 + 3 * 8) + 4 * 27 * 4 * 8 + 72 * 3    # 3744
    assert counts.conv_kernel_least_s([conv], stats, True) == \
        pytest.approx((k1_bytes + dw_bytes) / 3.35e12)
    # with its input's gradient: d_feats reads g and W, writes Cin columns
    conv = Conv("subm", 0, 4, 8, BF16)
    df_bytes = 2 * (3 * 8 + 27 * 8 * 4 + 3 * 4) + 72 * 3
    assert counts.conv_kernel_least_s([conv], stats, True) == \
        pytest.approx((k1_bytes + dw_bytes + df_bytes) / 3.35e12)


def test_wide_outputs_are_one_launch_a_block():
    stats = [(10, 50)]
    wide = Conv("subm", 0, 8, 256, F32, grad_in=False)
    e = 4
    per_block = [e * (10 * 8 + 27 * 8 * 128 + 10 * 128) + 720] * 2
    assert counts.conv_kernel_least_s([wide], stats, False) == \
        pytest.approx(sum(per_block) / 3.35e12)


def test_a_compute_bound_launch_takes_the_peak_of_its_dtype():
    stats = [(1000, 27000)]
    for dt, peak in ((BF16, 989e12), (F32, 495e12)):
        conv = Conv("subm", 0, 128, 128, dt, grad_in=False)
        ops = 2 * 27000 * 128 * 128
        assert counts.conv_kernel_least_s([conv], stats, False) == \
            pytest.approx(ops / peak)


def test_model_operations_by_hand():
    stats = [(3, 9), (1, 1)]
    convs = [Conv("subm", 0, 4, 8, BF16), Conv("down", 1, 8, 16, BF16),
             Conv("up", 0, 16, 8, BF16), Conv("one", 1, 16, 32, F32)]
    hand = (2 * 9 * 4 * 8 + 2 * 3 * 8 * 16 + 2 * 3 * 16 * 8) / 989e12 \
        + 2 * 1 * 16 * 32 / 495e12
    assert counts.conv_peak_s(convs, stats) == pytest.approx(hand)


def test_scn_conv_list():
    convs = scn.convs({"in_channels": 1, "m": 16, "num_planes": 7}, BF16)
    subm = [c for c in convs if c.kind == "subm"]
    assert len(subm) == 14 and sum(not c.grad_in for c in subm) == 1
    assert sum(c.kind == "down" for c in convs) == 6
    assert spvcnn.CS == (32, 32, 64, 128, 256, 256, 128, 96, 96)
    spv = spvcnn.convs({"in_channels": 4}, BF16)
    assert sum(c.kind == "subm" for c in spv) == 34
    assert {c.dtype for c in spv if c.kind == "subm" and c.level == 0
            and c.cin == 96 + 32} == {F32}


def test_unet2d_flops_match_a_count_of_every_conv():
    from benchmark.reference.net2d import UNetResNet34

    net = UNetResNet34(torch.float32).eval()
    total = []

    def hook(mod, inp, out):
        kh, kw = mod.kernel_size
        cin = mod.in_channels // mod.groups
        if isinstance(mod, torch.nn.ConvTranspose2d):
            total.append(2 * inp[0].numel() * mod.out_channels * kh * kw)
        else:
            total.append(2 * out.numel() * cin * kh * kw)

    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        net(torch.zeros(2, 32, 48, 3))
    assert counts.unet2d_flops(2, 32, 48) == sum(total)


def test_roundings():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0001, 1e-3])
    r = train._tf32(x)
    mant = (r.view(torch.int32) & 0x1FFF)
    assert (mant == 0).all()
    assert r[0] == 1.0 + 2 ** -10 and r[1] == 1.0 + 2 ** -9
    y = torch.randn(1000, dtype=torch.bfloat16)
    q = train._fp8(y)
    err = (q.float() - y.float()).abs() / y.float().abs().amax()
    assert 0 < float(err.max()) <= 2 ** -4
