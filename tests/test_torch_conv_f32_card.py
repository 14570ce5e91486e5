"""The float32 route on the card: its pair lists and span table
(``subm_conv_dw_pairs_count`` / ``_write``), K1 and ``d_feats``
(``subm_conv_pairs_f32_tc_kernel`` in ``csrc/submanifold_conv.cu``) and
``d_w`` (``subm_conv_dw_pairs_f32_tc_kernel`` in
``csrc/submanifold_conv_dw.cu``) against their plain twins, at the shapes
SPVCNN's float32 decoder gives them.

* The levels are those the benchmark's ``spvcnn.train_prebuilt`` cell
  trains on: one (source, target) pair of 8 + 8 synthetic KITTI-geometry
  scans of 16,384 points, made and planned as
  ``benchmark/drivers/prebuilt_train.py`` makes them.
* On levels 0-3, the device's pair lists equal ``pair_lists`` (every
  offset's pairs in order, and their counts) and its span table
  ``span_starts``.
* At every decoder conv shape (384 -> 256 as two column blocks, 256 ->
  256, 192 -> 128, 128 -> 128, 128 -> 96, 96 -> 96) on its level, K1,
  ``d_feats`` (the 384-wide one as two column blocks) and ``d_w`` within
  1e-4 of max|ref| of ``submanifold_conv_wide_ref`` / ``_dfeats_ref`` /
  ``_dw_ref`` (full float32 on the card), one launch per column block, and
  the same bits on a second run.
* On a plan flat in z, where the 18 offsets with dz != 0 have no pair:
  those lists empty, ``d_w``'s blocks there exactly zero, K1, ``d_feats``
  and ``d_w`` within 1e-4, at shapes that take the kernels' plain-load
  paths (Cin = 1, Cout = 20) and their vector paths.
* A whole SPVCNN step of the benchmark's cell (at the size of
  ``benchmark/tests/bench_small.card_driver``), traced: 7 host waits a
  step (``host_syncs.step``), 124 conv launches, and on the pair route 32
  lists (16 forward, 16 backward) and 20 launches each of K1, ``d_feats``
  and ``d_w`` a step.

This file imports neither JAX nor the JAX package; its tests run on the
card without ``tests/conftest.py`` (README: ``--noconftest``).
"""

import numpy as np
import pytest
import torch

from mopa_tpu_torch.common import spans
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.ops import sparse_conv as sc
from mopa_tpu_torch.ops import sparse_conv_cuda as scc

CELL = "spvcnn.train_prebuilt"
# (plan level, Cin, Cout) of SPVCNN's float32 decoder convs (DEFAULT_CS)
DECODER_SHAPES = [(3, 384, 256), (3, 256, 256), (2, 192, 128),
                  (2, 128, 128), (1, 128, 96), (1, 96, 96), (0, 128, 96),
                  (0, 96, 96)]
REL = 1e-4  # chip_smoke's float32 rule: max|err| <= 1e-4 max|ref|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def levels():
    """The benchmark cell's plan levels of one batch pair, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    from benchmark.drivers import prebuilt_train
    from benchmark.harness import train as harness
    from benchmark.tests.bench_small import files
    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import decode_batch

    conf, traffic = files(CELL)
    cfg = harness.TrainCell(conf, traffic, 5, "cpu").cfg
    (src, trg), = prebuilt_train.raw_pool(cfg, 1, harness.seeds(5)["data"])
    dev = torch.device("cuda")
    batches = [decode_batch(prebuilt_train.program_batch(cfg, b, None), dev)
               for b in (src, trg)]
    return trainer.build_train_plan(cfg, *batches, False)[0].levels


def _close(got, want):
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= REL * top, (err, top)


@pytest.mark.card
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_card_pair_lists_equal_the_twin(card, levels, level):
    lv = levels[level]
    v = lv.valid.shape[0]
    pairs, counts, starts = scc._pair_lists_cuda(lv.ranks, lv.sel, v,
                                                 scc.PAIR_SPAN)
    want_pairs, want_counts = scc.pair_lists(lv.ranks, lv.sel, v)
    assert torch.equal(counts, want_counts)
    for k in range(27):
        n = int(want_counts[k])
        assert torch.equal(pairs[k, :n], want_pairs[k, :n])
    assert torch.equal(starts, scc.span_starts(want_pairs, want_counts, v))
    print("level {}: V {}, pairs {}, pair share {:.4f}".format(
        level, v, int(counts.sum()), int(counts.sum()) / (27 * v)))


@pytest.mark.card
@pytest.mark.parametrize("level,cin,cout", DECODER_SHAPES)
def test_card_dw_f32_matches_the_twin(card, levels, level, cin, cout):
    lv = levels[level]
    v = lv.valid.shape[0]
    gen = torch.Generator(device=card).manual_seed(cin * 1000 + cout)
    feats = torch.randn((v, cin), generator=gen, device=card)
    g = torch.randn((v, cout), generator=gen, device=card)
    scc.reset_launch_counts()
    got = scc.submanifold_conv_wide_bwd_dw_cuda(g, feats, lv.ranks, lv.sel)
    blocks = len(scc.column_blocks(cout))
    assert scc.launches[scc.K2_DW] == scc.routes[scc.K2_DW][scc.TF32X3] \
        == blocks
    assert scc.pair_route == {"lists": 1, "k1": 0, "dfeats": 0,
                              "dw": blocks}
    again = scc.submanifold_conv_wide_bwd_dw_cuda(g, feats, lv.ranks, lv.sel)
    want = sc.submanifold_conv_wide_dw_ref(g, feats, lv.ranks, lv.sel)
    torch.cuda.synchronize()
    scc.reset_launch_counts()
    assert torch.equal(got, again)
    _close(got, want)


@pytest.mark.card
@pytest.mark.parametrize("level,cin,cout", DECODER_SHAPES)
def test_card_conv_f32_matches_the_twin(card, levels, level, cin, cout):
    """K1 and ``d_feats`` on the pair route, one set of lists a call."""
    lv = levels[level]
    v = lv.valid.shape[0]
    gen = torch.Generator(device=card).manual_seed(cin * 1000 + cout + 1)
    feats = torch.randn((v, cin), generator=gen, device=card)
    w = torch.randn((27, cin, cout), generator=gen, device=card) \
        * (2.0 / (27 * cin)) ** 0.5
    g = torch.randn((v, cout), generator=gen, device=card)
    for kernel, key, width, run, ref in (
            (scc.K1, "k1", cout,
             lambda: scc.submanifold_conv_wide_cuda(feats, lv.ranks, lv.sel,
                                                    w),
             lambda: sc.submanifold_conv_wide_ref(feats, lv.ranks, lv.sel,
                                                  w)),
            (scc.K2_DFEATS, "dfeats", cin,
             lambda: scc.submanifold_conv_wide_bwd_dfeats_cuda(
                 g, lv.ranks, lv.sel, w),
             lambda: sc.submanifold_conv_wide_dfeats_ref(g, lv.ranks,
                                                         lv.sel, w))):
        scc.reset_launch_counts()
        got = run()
        blocks = len(scc.column_blocks(width))
        assert scc.launches[kernel] == scc.routes[kernel][scc.TF32X3] \
            == blocks
        want_route = {"lists": 1, "k1": 0, "dfeats": 0, "dw": 0}
        want_route[key] = blocks
        assert scc.pair_route == want_route
        again = run()
        want = ref()
        torch.cuda.synchronize()
        scc.reset_launch_counts()
        assert got.shape == (v, width)
        assert torch.equal(got, again)
        _close(got, want)


def _z_flat_level(card, seed):
    rng = np.random.default_rng(seed)
    coords = rng.integers(0, 40, size=(2, 3000, 3)).astype(np.int32)
    coords[..., 2] = 7
    valid = np.ones((2, 3000), bool)
    valid[1, 2000:] = False
    return port_unet.build_unet_plan_batched(
        torch.from_numpy(coords).to(card), torch.from_numpy(valid).to(card),
        1, capacities=[6016]).levels[0]


@pytest.mark.card
@pytest.mark.parametrize("cin,cout", [(1, 16), (12, 20), (64, 48),
                                      (128, 96)])
def test_card_dw_f32_zero_pair_offsets(card, cin, cout):
    lv = _z_flat_level(card, cin + cout)
    v = lv.valid.shape[0]
    gen = torch.Generator(device=card).manual_seed(cin * 7 + cout)
    feats = torch.randn((v, cin), generator=gen, device=card)
    g = torch.randn((v, cout), generator=gen, device=card)
    _, counts, _ = scc._pair_lists_cuda(lv.ranks, lv.sel, v)
    dz0 = [k for k in range(27) if k % 3 == 1]
    empty = [k for k in range(27) if k not in dz0]
    assert not counts[empty].any() and counts[dz0].all()
    got = scc.submanifold_conv_wide_bwd_dw_cuda(g, feats, lv.ranks, lv.sel)
    want = sc.submanifold_conv_wide_dw_ref(g, feats, lv.ranks, lv.sel)
    assert not got[empty].any()
    _close(got, want)


@pytest.mark.card
@pytest.mark.parametrize("cin,cout", [(1, 16), (12, 20), (64, 48),
                                      (128, 96)])
def test_card_conv_f32_zero_pair_offsets(card, cin, cout):
    """K1 and ``d_feats`` where the 18 dz != 0 offsets have no pair (empty
    spans of the table), on the plain-load paths (Cin = 1: 4-byte rows; an
    output width of 1) and the vector paths."""
    lv = _z_flat_level(card, cin + cout)
    v = lv.valid.shape[0]
    gen = torch.Generator(device=card).manual_seed(cin * 11 + cout)
    feats = torch.randn((v, cin), generator=gen, device=card)
    w = torch.randn((27, cin, cout), generator=gen, device=card) * 0.1
    g = torch.randn((v, cout), generator=gen, device=card)
    _, counts, starts = scc._pair_lists_cuda(lv.ranks, lv.sel, v,
                                             scc.PAIR_SPAN)
    dz0 = [k for k in range(27) if k % 3 == 1]
    empty = [k for k in range(27) if k not in dz0]
    assert not starts[:, empty].any() and counts[dz0].all()
    got = scc.submanifold_conv_wide_cuda(feats, lv.ranks, lv.sel, w)
    _close(got, sc.submanifold_conv_wide_ref(feats, lv.ranks, lv.sel, w))
    got = scc.submanifold_conv_wide_bwd_dfeats_cuda(g, lv.ranks, lv.sel, w)
    _close(got, sc.submanifold_conv_wide_dfeats_ref(g, lv.ranks, lv.sel, w))


@pytest.mark.card
def test_card_spvcnn_step_keeps_its_waits(card):
    from benchmark.harness import core, trace
    from benchmark.tests.bench_small import card_driver

    spans.clear()
    scc.reset_launch_counts()
    drv = card_driver(CELL, 17)
    drv.setup()
    info, tr = trace.traced(lambda: drv.traced_window(30.0), drv.stages)
    ctx = {"trace": tr, "info": info}
    assert core.reader("host_syncs.step").read(ctx) == 7
    assert core.reader("conv_launches.step").read(ctx) == 124
    steps = spans.record().last(info["steps"]).steps
    assert steps
    for st in steps:
        route = {k: st.after["pair_route"][k] - st.before["pair_route"][k]
                 for k in scc.pair_route}
        assert route == {"lists": 32, "k1": 20, "dfeats": 20, "dw": 20}
    drv.release()
    spans.clear()
    scc.reset_launch_counts()
