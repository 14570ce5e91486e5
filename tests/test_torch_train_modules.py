"""The port's training-mode modules against the JAX reference, in float32.

* ``batch_norm_act`` in training mode with 1, 2 and 3 domains (one of them
  empty): outputs, new running statistics and gradients, 1e-5.
* ``DomainBatchNorm``, ``Net2DSeg`` (UNetResNet34 with the dense
  ``seg_logit_all`` head) and ``Net3DSeg`` (SCN) in training mode over two
  fused domains: outputs, batch statistics and parameter gradients, 1e-4 of
  each tensor's largest value. Dropout is neutralised on both sides (flax
  ``nn.Dropout`` patched to the identity, the port's rate set to 0): the two
  packages draw other bits. The nets' batch-norm biases start at 2 (see
  :func:`lift_bn_biases`), and a conv bias that feeds a batch norm, whose
  gradient is exactly 0, is held to 1e-4 of the net's largest gradient.
* The UDA losses and the confusion matrix: values and gradients to 1e-6
  relative, the matrix exactly.
* The optimizers: 5 updates on fixed gradients against optax.

Weights come from the reference's flax ``init`` through the weight bridge;
inputs from numpy seeds.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mopa_tpu.common import solver as jax_solver
from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.models import losses as jax_losses
from mopa_tpu.models import metric as jax_metric
from mopa_tpu.models import resnet34_unet as jax_r34
from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.models import xmuda_arch as jax_arch
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.ops import sparse_conv as jsc
from mopa_tpu_torch.common import solver as port_solver
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.models import losses as port_losses
from mopa_tpu_torch.models import metric as port_metric
from mopa_tpu_torch.models import resnet34_unet as port_r34
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.models import xmuda_arch as port_arch
from mopa_tpu_torch.ops import sparse_conv as psc

torch.set_num_threads(1)

NCLS = 5


def _identity_dropout(*args, **kwargs):
    return lambda x, *a, **k: x


def _close(got, want, rel, err_msg=""):
    """|got - want| <= rel * (|want| + max|want|): ``rel`` of the tensor's
    own scale."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


# ---------------------------------------------------------------- batch norm

@pytest.mark.parametrize("n_domains", [1, 2, 3])
def test_batch_norm_act_training(n_domains):
    """Masked statistics per domain, biased variance, sequential running
    updates; with 3 domains the last has no active voxel and leaves the
    running statistics untouched."""
    rng = np.random.default_rng(n_domains)
    v, c = 240, 12
    x = (rng.normal(size=(v, c)) * 2 + 0.7).astype(np.float32)
    valid = rng.random(v) < 0.8
    dom = np.repeat(np.arange(3), v // 3) % max(n_domains, 1)
    if n_domains == 3:
        valid[dom == 2] = False
    scale, bias = (rng.normal(size=(2, c)) + [[1.0], [0.0]]).astype(
        np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    ct = rng.normal(size=(v, c)).astype(np.float32)
    dom_j = None if n_domains == 1 else jnp.asarray(dom, jnp.int32)

    def jfn(x_, s_, b_):
        out, st = jsc.batch_norm_act(
            x_, jnp.asarray(valid), s_, b_,
            jsc.BNState(jnp.asarray(mean), jnp.asarray(var)), training=True,
            leakiness=0.1, dom=dom_j, n_domains=n_domains)
        return out, st

    want, vjp, want_st = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(scale),
                                 jnp.asarray(bias), has_aux=True)
    gx, gs, gb = vjp(jnp.asarray(ct))

    x_t = torch.from_numpy(x).requires_grad_()
    s_t = torch.from_numpy(scale).requires_grad_()
    b_t = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    got = psc.batch_norm_act(
        x_t, s_t, b_t, rm, rv, training=True, valid=torch.from_numpy(valid),
        dom=None if n_domains == 1 else torch.from_numpy(dom),
        n_domains=n_domains, leakiness=0.1)
    got.backward(torch.from_numpy(ct))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(rm.numpy(), np.asarray(want_st.running_mean),
                               **tol)
    np.testing.assert_allclose(rv.numpy(), np.asarray(want_st.running_var),
                               **tol)
    for g_t, g_j in ((x_t, gx), (s_t, gs), (b_t, gb)):
        np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(g_j), **tol)


def test_domain_batch_norm_training():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 6, 5, 8)) * 1.5 + 0.3).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    jbn = jax_r34.DomainBatchNorm(n_domains=2)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32),
              "bias": jnp.asarray(rng.normal(size=8), jnp.float32)}
    stats = {"mean": jnp.asarray(rng.normal(size=8), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, 8), jnp.float32)}

    def jfn(p, x_):
        return jbn.apply({"params": p, "batch_stats": stats}, x_, False,
                         mutable=["batch_stats"])

    want, vjp, new_stats = jax.vjp(jfn, params, jnp.asarray(x),
                                   has_aux=True)
    gp, gx = vjp(jnp.asarray(ct))

    bn = port_r34.DomainBatchNorm(8)
    weights.load_flax_state(bn, {k: np.asarray(v) for k, v in params.items()},
                            {k: np.asarray(v) for k, v in stats.items()})
    bn.train()
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = bn(x_t, n_domains=2)
    got.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(new_stats["batch_stats"][k]),
                                   **tol)
    np.testing.assert_allclose(x_t.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), **tol)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(gp["scale"]),
                               **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]),
                               **tol)


# ---------------------------------------------------------------- networks

def lift_bn_biases(params, value=2.0):
    """Flax params with every batch-norm bias (a module holding ``scale``)
    set to ``value``. The two frameworks' float32 forwards differ by ~1e-5,
    so a ReLU input within that of 0 can land on other sides of the kink;
    at these sizes one such element moves the gradient of every encoder
    tensor by ~1 %. Biases of 2 keep the ReLU inputs away from 0 (about 2 %
    stay masked) and the comparison holds to 1e-4."""
    if isinstance(params, dict) or hasattr(params, "items"):
        out = {k: lift_bn_biases(v, value) for k, v in params.items()}
        if "scale" in out and "bias" in out:
            out["bias"] = jnp.full_like(out["bias"], value)
        return out
    return params


def _zero_grad_bias(name):
    """A conv bias right before a training-mode batch norm: the norm takes
    out any constant, so its exact gradient is 0 and both sides hold
    rounding noise."""
    return name.endswith((".conv.bias", ".tconv.bias"))

def _net_grads_close(model, got_grads, want_grads, rel):
    got = weights.to_flax(model, got_grads)
    want = {k: np.asarray(v) for k, v in flatten_pytree(want_grads).items()}
    assert set(got) == set(want)
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        if _zero_grad_bias(k):
            assert max(np.abs(got[k]).max(), np.abs(want[k]).max()) \
                <= rel * top, k
        else:
            _close(got[k], want[k], rel, err_msg=k)


def _stats_close(model, want_stats, rel):
    got = weights.to_flax(model, dict(model.named_buffers()))
    want = {k: np.asarray(v) for k, v in flatten_pytree(want_stats).items()}
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rel, err_msg=k)


def test_net2d_training_two_domains(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _identity_dropout)
    rng = np.random.default_rng(1)
    b, h, w, p = 4, 32, 48, 64
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    idx = np.stack([rng.integers(0, h, (b, p)), rng.integers(0, w, (b, p))],
                   -1).astype(np.int32)
    pvalid = np.ones((b, p), bool)
    pvalid[-1, p // 2:] = False
    j2d = jax_arch.Net2DSeg(num_classes=NCLS, dual_head=True, output_all=True,
                            pretrained=False)
    v2d = jax.jit(j2d.init)(jax.random.PRNGKey(2), jnp.asarray(img),
                            jnp.asarray(idx), jnp.asarray(pvalid))
    v2d = {"params": lift_bn_biases(v2d["params"]),
           "batch_stats": v2d["batch_stats"]}
    cts = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("seg_logit", (b * p, NCLS)), ("seg_logit2", (b * p, NCLS)),
        ("seg_logit_all", (b, h, w, NCLS)), ("feats", (b * p, 64)))}

    def jloss(params):
        out, new = j2d.apply({"params": params,
                              "batch_stats": v2d["batch_stats"]},
                             jnp.asarray(img), jnp.asarray(idx),
                             jnp.asarray(pvalid), train=True, n_domains=2,
                             mutable=["batch_stats"])
        loss = sum(jnp.sum(out[k] * cts[k]) for k in cts)
        return loss, (out, new["batch_stats"])

    (_, (want, want_stats)), gp = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(v2d["params"])

    p2d = port_arch.Net2DSeg(NCLS, True, output_all=True)
    p2d.net_2d.dropout_rate = 0.0
    weights.load_flax_state(p2d, flatten_pytree(v2d["params"]),
                            flatten_pytree(v2d["batch_stats"]))
    p2d.train()
    got = p2d(torch.from_numpy(img), torch.from_numpy(idx),
              torch.from_numpy(pvalid), n_domains=2)
    assert set(got) == set(want)
    sum((got[k] * torch.from_numpy(cts[k])).sum() for k in cts).backward()
    for k in want:
        _close(got[k].detach().numpy(), want[k], 1e-4, err_msg=k)
    _stats_close(p2d, want_stats, 1e-4)
    _net_grads_close(p2d, {k: v.grad for k, v in p2d.named_parameters()},
                     gp, 1e-4)


def test_net3d_training_two_domains():
    rng = np.random.default_rng(3)
    s, p, levels = 4, 200, 3
    coords = rng.integers(0, 10, size=(s, p, 3)).astype(np.int32)
    valid = np.ones((s, p), bool)
    valid[1, 150:] = False
    valid[3, 120:] = False
    doms = [0, 0, 1, 1]
    caps = jax_unet.capacity_schedule(p, levels)
    # jitted: op-by-op dispatch of the plan build and of flax's init takes
    # tens of seconds on the CPU
    ref_plan = jax.jit(lambda c, v: jax_unet.build_unet_plan_batched(
        c, v, levels, capacities=caps,
        sample_domains=np.asarray(doms, np.int32)))(jnp.asarray(coords),
                                                    jnp.asarray(valid))
    port_plan = port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), levels,
        capacities=caps, sample_domains=doms)
    for lr, lp in zip(ref_plan.levels, port_plan.levels):
        np.testing.assert_array_equal(lp.dom.numpy(), np.asarray(lr.dom))
    feats = np.ones((s * p, 1), np.float32)
    j3d = jax_arch.Net3DSeg(num_classes=NCLS, dual_head=True, m=4,
                            num_planes=levels)
    v3d = jax.jit(j3d.init)(jax.random.PRNGKey(3), jnp.asarray(feats),
                            ref_plan)
    v3d = {"params": lift_bn_biases(v3d["params"]),
           "batch_stats": v3d["batch_stats"]}
    cts = {k: rng.normal(size=(s * p, n)).astype(np.float32)
           for k, n in (("seg_logit", NCLS), ("seg_logit2", NCLS),
                        ("feats", 4))}

    def jloss(params):
        out, new = j3d.apply({"params": params,
                              "batch_stats": v3d["batch_stats"]},
                             jnp.asarray(feats), ref_plan, train=True,
                             n_domains=2, mutable=["batch_stats"])
        return (sum(jnp.sum(out[k] * cts[k]) for k in cts),
                (out, new["batch_stats"]))

    (_, (want, want_stats)), gp = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(v3d["params"])

    p3d = port_arch.Net3DSeg(NCLS, True, m=4, num_planes=levels)
    weights.load_flax_state(p3d, flatten_pytree(v3d["params"]),
                            flatten_pytree(v3d["batch_stats"]))
    assert all(prm.dtype == torch.float32 for prm in p3d.parameters())
    p3d.train()
    got = p3d(torch.from_numpy(feats), port_plan, n_domains=2)
    sum((got[k] * torch.from_numpy(cts[k])).sum() for k in cts).backward()
    for k in want:
        _close(got[k].detach().numpy(), want[k], 1e-4, err_msg=k)
    _stats_close(p3d, want_stats, 1e-4)
    _net_grads_close(p3d, {k: v.grad for k, v in p3d.named_parameters()},
                     gp, 1e-4)


# ---------------------------------------------------------------- losses

def _value_and_grads(jfn, tfn, arrays):
    """(JAX value, JAX grads, port value, port grads) w.r.t. every array."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts)
    tv.backward()
    return jv, jg, tv, [t.grad for t in ts]


def _loss_close(jv, jg, tv, tg):
    _close(tv.detach().numpy(), jv, 1e-6)
    for got, want in zip(tg, jg):
        _close(got.numpy(), want, 1e-6)


def test_xm_kl_div_and_entropy():
    rng = np.random.default_rng(4)
    n = 300
    s = (rng.normal(size=(n, NCLS)) * 2).astype(np.float32)
    t = (rng.normal(size=(n, NCLS)) * 2).astype(np.float32)
    valid = rng.random(n) < 0.7
    vj, vt = jnp.asarray(valid), torch.from_numpy(valid)
    _loss_close(*_value_and_grads(
        lambda a, b: jax_losses.xm_kl_div(a, b, vj),
        lambda a, b: port_losses.xm_kl_div(a, b, vt), [s, t]))
    prob = np.array(jax.nn.softmax(jnp.asarray(s), -1))
    _loss_close(*_value_and_grads(
        lambda q: jax_losses.entropy_loss(q, vj),
        lambda q: port_losses.entropy_loss(q, vt), [prob]))
    _close(port_losses.prob_2_entropy(torch.from_numpy(prob)).numpy(),
           jax_losses.prob_2_entropy(jnp.asarray(prob)), 1e-6)


def test_mask_cons_loss():
    """Including an image with no mask (it adds 0 to the batch mean) and ids
    at and past the budget (ignored)."""
    rng = np.random.default_rng(5)
    b, h, w, m = 3, 16, 24, 6
    logits = rng.normal(size=(b, h, w, NCLS)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    masks = np.repeat(np.repeat(rng.integers(-1, m + 2, (b, h // 4, w // 4)),
                                4, 1), 4, 2)
    masks[1] = -1
    _loss_close(*_value_and_grads(
        lambda q: jax_losses.mask_cons_loss(q, jnp.asarray(masks), m),
        lambda q: port_losses.mask_cons_loss(q, torch.from_numpy(masks), m),
        [probs]))


def test_confusion_matrix():
    rng = np.random.default_rng(6)
    n = 500
    logits = rng.normal(size=(n, NCLS)).astype(np.float32)
    labels = rng.integers(-1, NCLS + 1, n)
    labels[:20] = -100
    valid = rng.random(n) < 0.8
    want = jax_metric.confusion_matrix(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       jnp.asarray(valid), NCLS)
    got = port_metric.confusion_matrix(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       torch.from_numpy(valid), NCLS)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- optimizers

def _solver_cfg(base, kind, clip, wd):
    c = base.clone()
    c.OPTIMIZER.MODEL_3D.TYPE = kind
    c.OPTIMIZER.MODEL_3D.BASE_LR = 0.1
    c.OPTIMIZER.MODEL_3D.WEIGHT_DECAY = wd
    c.SCHEDULER.TYPE = "MultiStepLR"
    c.SCHEDULER.MultiStepLR.milestones = (2, 4)
    c.SCHEDULER.MultiStepLR.gamma = 0.1
    c.SCHEDULER.CLIP_LR = clip
    # powers of these betas are exact in float32, where optax computes the
    # bias corrections 1 - beta^t (torch computes them in float64; with the
    # shipped 0.999 the float32 rounding of 1 - 0.999 alone is 1.3e-5)
    c.OPTIMIZER.MODEL_3D.Adam.betas = (0.5, 0.75)
    return c


@pytest.mark.parametrize("kind,clip,wd", [("Adam", 0.0, 0.0),
                                          ("Adam", 0.005, 1e-3),
                                          ("SGD", 0.0, 1e-3)])
def test_optimizer_five_steps_match_optax(kind, clip, wd):
    """Milestones at updates 2 and 4 (gamma 0.1); the ClipLR case floors the
    last learning rate (0.1 * 0.01) at 0.005."""
    rng = np.random.default_rng(7)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(5)]
    tx = jax_solver.build_optimizer(
        _solver_cfg(jax_base_cfg, kind, clip, wd).OPTIMIZER.MODEL_3D,
        _solver_cfg(jax_base_cfg, kind, clip, wd))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    pc = _solver_cfg(port_base_cfg, kind, clip, wd)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = port_solver.build_optimizer(pc.OPTIMIZER.MODEL_3D, pc).init(tp)
    for g in grads:
        upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
    assert opt.count == 5
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)
