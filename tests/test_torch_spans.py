"""The port's spans and their record (``mopa_tpu_torch.common.spans``), and
the benchmark's three readers of that record.

* (a) Off (no profiler, no ``recording()``): a span is one shared object
  that records nothing.
* (b) Two pre-EMA train steps on the CPU under ``torch.profiler``, at the
  small configuration of ``test_torch_train_step.py`` (2 + 2 scans of 256
  points, 32 x 48 images, SCN m=4 over 3 levels, every loss but VGI): one
  ``train/step`` span a step with id ``state.step``, the stages as its
  children in :data:`TRAIN_STAGES`' order, the sub-stage spans under
  their stages, each recorded span of the trace around the profiler's
  range of the same name on the same clock, and the sub-stage spans
  (``trace=False``) absent from the trace.
* Each profiler session starts the record afresh; two sessions back to
  back share it, and :meth:`Record.last` keeps the second's steps.
* The host-wait hook on the CPU, fed CUDA's sync warning by hand: each
  counted once at the innermost open span, on another thread at the
  innermost span of the thread that opened the step; the warnings'
  filters and hook restored after. A conv launch (``sparse_conv_cuda.
  _launch`` on a stub library) opens no span, and the step's copies of
  the launch counter differ by its launches.
* (c) The readers ``host_syncs.step``, ``sync_idle_ms.step`` and
  ``conv_launches.step`` on a fabricated record and trace, over the
  window's steps alone, and None on an empty record.
* (d) On the card (``card``): planted waits, among them one inside a
  custom autograd ``backward`` on autograd's thread, each counted once at
  its span; both benchmark cells' steps at a small size traced, every
  counted wait inside a ``sync/*`` span, the three readers reporting, and
  the launches a traced step equal to one step run alone.

This file imports neither JAX nor the JAX package; its card tests run
without ``tests/conftest.py`` (README: ``--noconftest``).
"""

import contextlib
import statistics
import threading
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mopa_tpu_torch.common import spans
from mopa_tpu_torch.config.xmuda import cfg as base_cfg
from mopa_tpu_torch.ops import sparse_conv_cuda as scc
from mopa_tpu_torch.train import trainer
from mopa_tpu_torch.train.common import host_metrics

B, P, H, W, NCLS, BUDGET = 2, 256, 32, 48, 5, 8
# the profiler's range lies inside its span, a typical edge within this (ns)
BRACKET_NS = 50_000
# where each sub-stage span of the CPU step sits: a stage of the step
UNDER = {"plan/": "train/plan", "net2d/": "train/net2d",
         "net3d/": "train/net3d", "loss/": "train/losses",
         "sync/cm_bincount": "loss/cm"}
# the sub-stage spans, kept out of the profiler's trace
UNTRACED = ("plan/", "net2d/", "net3d/", "loss/")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")


@pytest.fixture
def clean():
    spans.clear()
    scc.reset_launch_counts()
    yield
    spans.clear()
    scc.reset_launch_counts()


def _cfg():
    c = base_cfg.clone()
    c.MODEL_2D.TYPE = "UNetResNet34"
    c.MODEL_3D.TYPE = "SCN"
    c.MODEL_2D.NUM_CLASSES = NCLS
    c.MODEL_3D.NUM_CLASSES = NCLS
    c.MODEL_2D.DUAL_HEAD = True
    c.MODEL_3D.DUAL_HEAD = True
    c.MODEL_2D.UNetResNet34.pretrained = False
    c.MODEL_3D.SCN.m = 4
    c.MODEL_3D.SCN.num_planes = 3
    c.OPTIMIZER.MODEL_2D.TYPE = "Adam"
    c.OPTIMIZER.MODEL_3D.TYPE = "Adam"
    c.TRAIN.XMUDA.lambda_xm_src = 1.0
    c.TRAIN.XMUDA.lambda_xm_trg = 0.1
    c.TRAIN.XMUDA.lambda_pl = 1.0
    c.TRAIN.XMUDA.lambda_minent = 0.05
    c.TRAIN.PC_MM.lambda_sam_cons = 0.5
    c.TRAIN.PC_MM.lambda_pc_mm = 0.0
    c.TPU.POINT_BUDGET = P
    c.TPU.SAM_MASK_BUDGET = BUDGET
    c.TPU.COMPUTE_DTYPE = "float32"
    return c


def _batch(seed, target):
    rng = np.random.default_rng(seed)
    coords = np.zeros((B, P, 3), np.int64)
    valid = np.zeros((B, P), bool)
    labels = np.full((B, P), -100, np.int64)
    for i, n in enumerate((P, 200)):
        c = rng.integers(0, 9, size=(n, 3))
        key = (c[:, 0] * 4096 + c[:, 1]) * 4096 + c[:, 2]
        coords[i, :n] = c[np.argsort(key, kind="stable")]
        valid[i, :n] = True
        labels[i, :n] = rng.integers(-1, NCLS, n)
    out = {"img": rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8),
           "img_indices": np.stack([rng.integers(0, H, (B, P)),
                                    rng.integers(0, W, (B, P))], -1),
           "coords": coords.reshape(B * P, 3),
           "seg_label": labels.reshape(B * P),
           "num_points": valid.sum(1),
           "feats_ones": np.ones((B, 1), np.float32)}
    if target:
        out["pseudo_label_2d"] = labels.reshape(-1)
        out["pseudo_label_3d"] = labels.reshape(-1)
        masks = rng.integers(-1, BUDGET, (B, H // 8, W // 8))
        out["sam_mask"] = np.repeat(np.repeat(masks, 8, 1), 8, 2)
    return out


def _ancestors(span, by_id):
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span.name)
    return out


def test_off_records_nothing(clean):
    assert spans.span("a") is spans.span("b", step=3)
    show, filters = warnings.showwarning, list(warnings.filters)
    with spans.span("train/step", step=1):
        with spans.span("x"):
            assert warnings.showwarning is show
    rec = spans.record()
    assert not rec and rec.spans == rec.waits == rec.steps == []
    assert warnings.filters == filters


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cpu_step_under_profiler(clean, one_thread):
    torch.manual_seed(0)
    cfg = _cfg()
    models = trainer.build_models(cfg, device="cpu", seed=0)
    state = trainer.create_train_state(cfg, models, seed=0)
    step = trainer.make_train_step(cfg, models, with_pl=True)
    src, trg = _batch(1, False), _batch(2, True)
    state, metrics = step(state, src, trg)
    host_metrics(metrics)
    assert not spans.record()
    first = state.step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, metrics = step(state, src, trg)
            host_metrics(metrics)
    rec = spans.record()
    by_id = {s.id: s for s in rec.spans}
    steps = [s for s in rec.spans if s.name == trainer.STEP_SPAN]
    assert [s.step for s in steps] == [first, first + 1]
    assert [s.step for s in rec.steps] == [first, first + 1]
    assert all(s.before.keys() == s.after.keys()
               == {"launches", "pair_route", "ptv3.attn"}
               for s in rec.steps)
    want = ["train/decode", "train/plan", "train/net2d", "train/net3d",
            "train/losses", "train/backward", "train/optim", "train/ema"]
    for st in steps:
        kids = sorted((s for s in rec.spans if s.parent == st.id),
                      key=lambda s: s.start_ns)
        assert [k.name for k in kids] == want
        assert all(st.start_ns <= k.start_ns and k.end_ns <= st.end_ns
                   for k in kids)
    names = Counter(s.name for s in rec.spans)
    for name in ("plan/build", "net2d/encoder", "net2d/decoder",
                 "net2d/lift", "net2d/heads", "net3d/down0", "net3d/down2",
                 "net3d/up0", "net3d/up1", "loss/ce", "loss/pl",
                 "loss/minent", "loss/sam", "loss/cm", "sync/cm_bincount",
                 "sync/metrics_to_host"):
        assert names[name] >= 2, name
    # 4 batch norms at each of the upper two levels, 1 at the last, 1 final
    assert names["net3d/bn"] == 2 * 10 and names["loss/xm"] == 2 * 2
    for s in rec.spans:
        for prefix, stage in UNDER.items():
            if s.name.startswith(prefix):
                assert stage in _ancestors(s, by_id), (s.name, stage)
        if s.name != "sync/metrics_to_host":
            assert trainer.STEP_SPAN in _ancestors(s, by_id) \
                or s.name == trainer.STEP_SPAN
        assert s.step in (first, first + 1)
    assert rec.waits == []      # no wait on the CPU

    # one clock: each span of the trace holds the profiler's range of its
    # name; a sub-stage span has none
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in names:
            ranges.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    traced = {n for n in names if not n.startswith(UNTRACED)}
    assert set(ranges) == traced == set(want) | {
        trainer.STEP_SPAN, "sync/cm_bincount", "sync/metrics_to_host"}
    lead, lag = [], []
    for name in traced:
        mine = sorted((s.start_ns, s.end_ns) for s in rec.spans
                      if s.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            lead.append(c - a)
            lag.append(b - d)
    # a span opens before its range and closes after it (within the
    # conversion of the profiler's clock, a few us); the typical edge lies
    # within BRACKET_NS, and a host preempted between the two stretches one
    # edge by at most a scheduler's slice, never by a clock's offset
    for gaps in (lead, lag):
        assert min(gaps) >= -5_000 and max(gaps) < 100_000_000
        assert statistics.median(gaps) < BRACKET_NS


def test_each_profiler_session_starts_the_record(clean):
    def window(step):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("train/step", step=step):
                with spans.span("sub", trace=False):
                    pass
        return [ev.name() for ev in prof.profiler.kineto_results.events()
                if ev.name() in ("train/step", "sub")]

    for step in (3, 4):
        with spans.span("between"):     # off: not recorded
            pass
        assert window(step) == ["train/step"]
        rec = spans.record()
        assert [(s.name, s.step) for s in rec.spans] == [
            ("sub", step), ("train/step", step)]
        assert [s.step for s in rec.steps] == [step]
    window(5)                           # back to back: one record
    rec = spans.record()
    assert [s.step for s in rec.steps] == [4, 5]
    last = rec.last(1)
    assert [s.step for s in last.steps] == [5]
    assert [(s.name, s.step) for s in last.spans] == [("sub", 5),
                                                      ("train/step", 5)]
    assert not rec.last(0)


def _warn_sync():
    warnings.warn(spans.SYNC_WARNING)


def test_waits_counted_at_their_span(clean, monkeypatch):
    shown = []
    monkeypatch.setattr(warnings, "showwarning",
                        lambda message, *args: shown.append(str(message)))
    show, filters = warnings.showwarning, list(warnings.filters)
    with spans.recording() as rec:
        with spans.span("train/step", step=4):
            with spans.span("outer"):
                with spans.span("sync/a"):
                    _warn_sync()
                    _warn_sync()
                    warnings.warn("unrelated to the device")
            t = threading.Thread(target=_warn_sync)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with spans.span("sync/metrics_to_host"):
            _warn_sync()
    _warn_sync()                # not recording: shown, not counted
    assert shown == ["unrelated to the device", spans.SYNC_WARNING]
    assert [(w.name, w.step) for w in rec.waits] == [
        ("sync/a", 4), ("sync/a", 4), ("train/step", 4),
        ("sync/metrics_to_host", 4)]
    ids = {s.name: s.id for s in rec.spans}
    assert [w.span for w in rec.waits] == [ids["sync/a"], ids["sync/a"],
                                           ids["train/step"],
                                           ids["sync/metrics_to_host"]]
    assert all("test_torch_spans.py:" in w.site for w in rec.waits)
    assert warnings.showwarning is show and warnings.filters == filters


def test_conv_launches_counted_by_the_step(clean, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(scc, "_stream", lambda device: 0)
    got = []

    def lib(*args):
        got.append(args)
        return 0

    x = torch.zeros(4)
    with spans.recording() as rec:
        with spans.span("train/step", step=9):
            for kernel in (scc.K1, scc.K2_DFEATS, scc.K2_DW, scc.K1):
                scc._launch(kernel, scc.TENSOR_CORE, lib, "cpu", x, 3)
    assert got == [(x.data_ptr(), 3, 0)] * 4
    assert [s.name for s in rec.spans] == ["train/step"]
    (st,) = rec.steps
    assert st.step == 9
    delta = {k: st.after["launches"][k] - st.before["launches"][k]
             for k in st.after["launches"]}
    assert delta == {scc.K1: 2, scc.K2_DFEATS: 1, scc.K2_DW: 1, scc.P1: 0,
                     scc.P2: 0}


def _reader(name):
    from benchmark.harness import core

    return core.reader(name)


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_s(self, pred) -> float:
        return sum(e - s for n, s, e in self.kernels if pred(n)) / 1e9


def _launches(k1, k2f, k2w):
    return {"launches": {scc.K1: k1, scc.K2_DFEATS: k2f, scc.K2_DW: k2w,
                         scc.P1: 0, scc.P2: 0}}


def test_readers_on_a_fabricated_record(monkeypatch):
    S, Wt, C = spans.Span, spans.Wait, spans.StepCounts
    ms = 1_000_000
    # step 7 is an earlier window's, which the readers leave out
    rec = spans.Record(
        spans=[S(8, "sync/z", 9, 7, -50 * ms, -40 * ms, 1),
               S(9, "train/step", None, 7, -60 * ms, -30 * ms, 1),
               S(1, "sync/a", 0, 0, 10 * ms, 20 * ms, 1),
               S(0, "train/step", None, 0, 0, 100 * ms, 1),
               S(3, "sync/b", 2, 1, 150 * ms, 175 * ms, 1),
               S(4, "sync/c", 2, 1, 180 * ms, 181 * ms, 1),
               S(2, "train/step", None, 1, 100 * ms, 200 * ms, 1)],
        waits=[Wt(8, "sync/z", "m.py:9", 7),
               Wt(1, "sync/a", "m.py:1", 0),
               Wt(3, "sync/b", "m.py:2", 1),
               Wt(3, "sync/b", "m.py:3", 1)],
        steps=[C(7, _launches(0, 0, 0), _launches(1, 1, 1)),
               C(0, _launches(0, 0, 0), _launches(14, 13, 14)),
               C(1, _launches(14, 13, 14), _launches(28, 26, 28))])
    # busy [-45, -44], [0, 16], [25, 30], [150, 170], [180, 190] ms
    # (overlaps merged): the gaps open at -44 (inside step 7's sync/z: not
    # counted), 16 (inside sync/a: 9 ms idle), 30 (no sync span), 170
    # (inside sync/b: 10 ms) and nowhere else
    trace = _Trace([("k", -45 * ms, -44 * ms),
                    ("k", 0, 15 * ms), ("k", 14 * ms, 16 * ms),
                    ("k", 25 * ms, 30 * ms), ("k", 150 * ms, 170 * ms),
                    ("k", 180 * ms, 185 * ms), ("k", 182 * ms, 190 * ms)])
    ctx = {"trace": trace, "info": {"steps": 2}}
    monkeypatch.setattr(spans._R, "record", rec)
    assert _reader("host_syncs.step").read(ctx) == 1.5
    assert _reader("sync_idle_ms.step").read(ctx) == pytest.approx(9.5)
    assert _reader("conv_launches.step").read(ctx) == 41.0
    assert _reader("sync_idle_ms.step").read(dict(ctx, trace=None)) is None
    monkeypatch.setattr(spans._R, "record", spans.Record())
    for name in ("host_syncs.step", "sync_idle_ms.step",
                 "conv_launches.step"):
        assert _reader(name).read(ctx) is None, name


def test_attention_readers_on_a_fabricated_record(monkeypatch):
    """PTv3's readers: the attention kernels' ms a step and their share of
    the net's least time (kernels named by ``flash``), and the real
    patches' tokens over the tokens the counter ``ptv3.attn`` ran; None
    where nothing is read."""
    C = spans.StepCounts
    ms = 1_000_000
    tok = [{"ptv3.attn": {"launches": n, "tokens": t}}
           for n, t in ((0, 0), (22, 4000), (44, 8000))]
    rec = spans.Record(steps=[C(0, tok[0], tok[1]), C(1, tok[1], tok[2])])
    trace = _Trace([("pytorch_flash::flash_fwd_kernel", 0, 3 * ms),
                    ("pytorch_flash::flash_bwd_dq_dk_dv", 5 * ms, 10 * ms),
                    ("subm_conv_tc_kernel", 10 * ms, 40 * ms)])
    ctx = {"trace": trace, "info": {"steps": 2},
           "work": {"ptv3_attn_least_s": 4e-3, "ptv3_attn_tokens": 6800.0}}
    monkeypatch.setattr(spans._R, "record", rec)
    assert _reader("attn_ms.step").read(ctx) == pytest.approx(4.0)
    assert _reader("attn_roofline.step").read(ctx) == pytest.approx(50.0)
    assert _reader("attn_fill.step").read(ctx) == pytest.approx(85.0)
    # no attention kernel, no net count, no trace, no counter: None
    other = _Trace([("subm_conv_tc_kernel", 0, ms)])
    assert _reader("attn_ms.step").read(dict(ctx, trace=other)) is None
    assert _reader("attn_roofline.step").read(dict(ctx, work={})) is None
    monkeypatch.setattr(spans._R, "record", spans.Record())
    for name in ("attn_ms.step", "attn_roofline.step", "attn_fill.step"):
        assert _reader(name).read(dict(ctx, trace=None)) is None, name


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with spans.span("sync/in_backward"):
            g.sum().item()
        return 2 * g


@pytest.mark.card
def test_card_planted_waits(card, clean):
    x = torch.arange(16.0, device=card)
    w = torch.ones(16, device=card, requires_grad=True)
    torch.cuda.synchronize()
    with spans.recording() as rec:
        with spans.span("train/step", step=0):
            with spans.span("sync/item"):
                x.sum().item()
            with spans.span("sync/mask"):
                x[x > 3]
            with spans.span("sync/nonzero"):
                torch.nonzero(x)
            with spans.span("train/backward"):
                _Twice.apply(w).sum().backward()
            (x * 2).sum()       # no wait
    assert Counter(w.name for w in rec.waits) == {
        "sync/item": 1, "sync/mask": 1, "sync/nonzero": 1,
        "sync/in_backward": 1}
    back = next(s for s in rec.spans if s.name == "sync/in_backward")
    top = next(s for s in rec.spans if s.name == "train/backward")
    assert back.parent == top.id and back.thread != top.thread
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mopa_scn.train_prebuilt",
                                  "spvcnn.train_prebuilt"])
def test_card_cell_waits_inside_sync_spans(card, clean, cell):
    from benchmark.harness import trace
    from benchmark.tests.bench_small import card_driver

    drv = card_driver(cell, 11)
    drv.setup()
    info, tr = trace.traced(lambda: drv.traced_window(30.0), drv.stages)
    rec = spans.record()
    ctx = {"trace": tr, "info": info}
    assert len([s for s in rec.spans if s.name == trainer.STEP_SPAN]) \
        == info["steps"] == 2
    assert rec.waits
    outside = [w for w in rec.waits if not w.name.startswith("sync/")]
    assert not outside, outside
    got = {m: _reader(m).read(ctx) for m in (
        "host_syncs.step", "sync_idle_ms.step", "conv_launches.step")}
    assert all(v is not None for v in got.values()), got
    before = dict(scc.launches)
    drv.cell.step(*drv.pool[0])
    alone = sum(scc.launches[k] - before[k]
                for k in (scc.K1, scc.K2_DFEATS, scc.K2_DW))
    assert got["conv_launches.step"] == alone
    drv.release()
