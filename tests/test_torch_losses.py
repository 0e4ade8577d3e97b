"""PyTorch port, the pieces of the training step: losses
(``ops/losses.py``), the head's backward (``ops/prototype.py``) and the
phase optimizers (``train/optimizer.py``) against the JAX package, on
numpy-seeded inputs.  Tolerances:

* loss values rtol ``RTOL``; their input gradients atol ``GRAD_ATOL``
  relative to the largest JAX gradient (f32 sums in other orders);
* the head's backward against ``jax.vjp`` of
  ``adlm_tpu.ops.prototype.prototype_head`` (its custom VJP, the XLA
  branch on the CPU) and against autograd through the port's
  ``prototype_head_reference``: ``HEAD_RTOL`` of the largest gradient;
  bf16 inputs get gradients in bf16, within ``HEAD_BF16_RTOL`` of JAX's
  (one bf16 rounding of each output);
* Adam updates: the same gradients go to both optimizers, and the
  parameters agree within ``ADAM_RTOL`` after every update (the lr per
  update is also checked directly against the JAX schedule).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from adlm_tpu.core import config as jcfg_mod
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.ops import losses as jlosses
from adlm_tpu.ops.prototype import prototype_head as jax_head
from adlm_tpu.train import optimizer as jopt

from adlm_tpu_torch.core import config as tcfg_mod
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.ops import losses as tlosses
from adlm_tpu_torch.ops.prototype import prototype_head, prototype_head_reference
from adlm_tpu_torch.train import optimizer as topt
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

from test_torch_models import random_variables

RTOL = 1e-5
GRAD_ATOL = 1e-5
HEAD_RTOL = 1e-5
HEAD_BF16_RTOL = 1e-2
ADAM_RTOL = 1e-5


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close_grads(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_ATOL * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [None, 2, 4])
def test_cross_entropy_ignore_matches_jax(groups):
    rng = np.random.RandomState(0)
    logits = rng.randn(48, 5).astype(np.float32)
    labels = rng.randint(0, 5, 48).astype(np.int32)
    valid = rng.rand(48) > 0.3
    valid[36:] = False  # the last group (of 4) has no valid row
    logits[3, labels[3]] = logits[3].max()  # a tie with the label
    for v in (valid, None):
        jv = None if v is None else jnp.asarray(v)
        f = lambda lg: jlosses.cross_entropy_ignore(lg, jnp.asarray(labels), jv,
                                                    groups)
        (want, want_n), vjp = jax.vjp(f, jnp.asarray(logits))
        lg = _t(logits, True)
        got, got_n = tlosses.cross_entropy_ignore(
            lg, torch.from_numpy(labels), None if v is None else torch.from_numpy(v),
            groups)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
        assert int(got_n) == int(want_n)
        got.backward()
        _close_grads(lg.grad, vjp((jnp.ones(()), np.zeros((), np.int32)))[0])


def _kld_inputs(seed, void_images=()):
    rng = np.random.RandomState(seed)
    acts = (rng.rand(4, 30, 6) * 5).astype(np.float32)
    labels = rng.randint(-1, 3, (4, 30)).astype(np.int32)
    for b in void_images:
        labels[b] = -1
    return acts, labels, np.repeat(np.arange(3), 2).astype(np.int32)


@pytest.mark.parametrize("groups", [None, 2])
@pytest.mark.parametrize("case", ["mixed", "one_group_empty", "no_valid_pair"])
def test_kld_prototype_loss_matches_jax(case, groups):
    void = {"mixed": (1,), "one_group_empty": (0, 1),
            "no_valid_pair": (0, 1, 2, 3)}[case]
    acts, labels, pc = _kld_inputs(1, void)
    if case == "mixed":
        labels[2] = 0
        labels[2, 0] = 1  # one pixel of class 1: no pair of its prototypes
    f = lambda a: jlosses.kld_prototype_loss(a, jnp.asarray(labels),
                                             jnp.asarray(pc), groups)
    want, vjp = jax.vjp(f, jnp.asarray(acts))
    a = _t(acts, True)
    got = tlosses.kld_prototype_loss(a, torch.from_numpy(labels),
                                     torch.from_numpy(pc), groups)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    if case == "no_valid_pair":
        assert float(got) == 0.0
    got.backward()
    _close_grads(a.grad, vjp(jnp.ones(()))[0])


def test_masked_l1_matches_jax():
    rng = np.random.RandomState(2)
    w = rng.randn(6, 3).astype(np.float32)
    pc = np.repeat(np.arange(3), 2).astype(np.int32)
    want, vjp = jax.vjp(lambda x: jlosses.masked_l1(x, jnp.asarray(pc)),
                        jnp.asarray(w))
    wt = _t(w, True)
    got = tlosses.masked_l1(wt, torch.from_numpy(pc))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    got.backward()
    _close_grads(wt.grad, vjp(jnp.ones(()))[0])


# ---------------------------------------------------------------------------
# the head's backward
# ---------------------------------------------------------------------------

def _head_inputs(dtype):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 5, 7, 8).astype(np.float32)
    p = rng.rand(6, 8).astype(np.float32)
    w = rng.randn(6, 3).astype(np.float32)
    x[0, 0, 0] = 0.0   # d == 0 exactly at (row 0, prototype 1): the relu
    p[1] = 0.0         # mask's edge
    g_logits = rng.randn(2, 5, 7, 3).astype(np.float32)
    g_dist = rng.randn(2, 5, 7, 6).astype(np.float32)
    if dtype == "bfloat16":  # round once, so both packages see the same
        x, p, w = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                   for a in (x, p, w))
    return x, p, w, g_logits, g_dist


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_dist", [True, False])
@pytest.mark.parametrize("act", ["log", "linear"])
def test_head_backward_matches_jax_vjp(act, with_dist, dtype):
    x, p, w, g_logits, g_dist = _head_inputs(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    f = lambda a, b, c: jax_head(a, b, c, act, 1e-4, with_dist)
    _, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (x, p, w)))
    want = vjp((jnp.asarray(g_logits), jnp.asarray(g_dist) if with_dist else None))

    ins = [torch.tensor(a, dtype=tdt, requires_grad=True) for a in (x, p, w)]
    logits, d = prototype_head(*ins, act, 1e-4, with_dist)
    assert (d is None) == (not with_dist)
    loss = (logits * _t(g_logits)).sum()
    if with_dist:
        loss = loss + (d * _t(g_dist)).sum()
    loss.backward()
    tol = HEAD_RTOL if dtype == "float32" else HEAD_BF16_RTOL
    for got, wj in zip(ins, want):
        assert got.grad.dtype == tdt
        wj = np.asarray(wj.astype(jnp.float32))
        np.testing.assert_allclose(got.grad.float().numpy(), wj, rtol=0,
                                   atol=tol * np.abs(wj).max())

    if dtype == "float32":  # and autograd through the plain version
        ref = [_t(a, True) for a in (x, p, w)]
        rl, rd = prototype_head_reference(*ref, act, 1e-4)
        rloss = (rl * _t(g_logits)).sum()
        if with_dist:
            rloss = rloss + (rd * _t(g_dist)).sum()
        rloss.backward()
        for got, r in zip(ins, ref):
            np.testing.assert_allclose(got.grad.numpy(), r.grad.numpy(), rtol=0,
                                       atol=HEAD_RTOL * r.grad.abs().max().item())


def test_head_takes_the_plain_path_without_grad():
    x, p, w, _, _ = _head_inputs("float32")
    with torch.no_grad():
        logits, d = prototype_head(_t(x), _t(p), _t(w))
    assert logits.grad_fn is None and d.grad_fn is None


# ---------------------------------------------------------------------------
# optimizer groups, schedule, Adam, clipping
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tiny_params(add_on, presigmoid_ln):
    kw = dict(num_prototypes=6, num_classes=3, prototype_channels=8,
              deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1),
              add_on_layers_type=add_on, presigmoid_ln=presigmoid_ln)
    if add_on == "bottleneck_pool":
        kw["bottleneck_stride"] = 2
    jm = JaxPPNet(cfg=jcfg_mod.PPNetConfig(**kw))
    params, constants = random_variables(jm, 4)
    return kw, params, constants


def _tiny(add_on="regular", presigmoid_ln=False):
    """(JAX params, port PPNet with the same weights); built once per
    kind, a fresh port model each call."""
    kw, params, constants = _tiny_params(add_on, presigmoid_ln)
    tm = PPNet(tcfg_mod.PPNetConfig(**kw))
    tm.load_state_dict(state_dict_from_jax(params, constants), strict=True)
    return params, tm


GROUPS = (jopt.BACKBONE, jopt.ASPP_W, jopt.ASPP_B, jopt.ADD_ON, jopt.PROTOS,
          jopt.LAST, jopt.FROZEN)


@pytest.mark.parametrize("add_on,ln", [("deeplab_simple", False),
                                       ("regular", True),
                                       ("bottleneck_pool", False)])
def test_label_params_match_jax(add_on, ln):
    params, tm = _tiny(add_on, ln)
    # each JAX leaf filled with its group's index, carried by name
    coded = jax.tree.map(lambda lab, v: np.full(np.shape(v), GROUPS.index(lab),
                                                np.float32),
                         jopt.label_params(params), params)
    want = {k: GROUPS[int(v.flatten()[0])]
            for k, v in state_dict_from_jax(coded).items()}
    got = topt.label_params(tm)
    assert got == want
    assert dict(topt.label_params(tm)) and set(got) == {n for n, _ in tm.named_parameters()}
    assert got["features.base.aspp.c0.bias"] == topt.ASPP_B
    assert got["features.base.aspp.c0.weight"] == topt.ASPP_W


OPT_CASES = {
    "warmup": (0, {}),
    "joint": (1, {}),
    "joint_ramp": (1, dict(joint_lr_warmup_updates=3)),
    "last_layer": (2, {}),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_updates_match_optax(case):
    """Seven updates with the same random gradients (weight decay on).
    The joint budget is 5 updates; past it the port's lr is exactly 0,
    so nothing moves.  (There the jitted JAX schedule gives NaN: XLA
    turns ``min(c, 5)/5`` into ``c·(1/5)``, so ``1 − 5·0.2f`` is
    −1.5e-8 and its 0.9th power NaN; a run inside its budget never
    reaches that count.)"""
    phase, kw = OPT_CASES[case]
    jtc = jcfg_mod.TrainConfig(iter_size=2, **kw)
    ttc = tcfg_mod.TrainConfig(iter_size=2, **kw)
    max_steps, budget = 10, 5
    params, tm = _tiny()
    tx = jopt.make_optimizer(jtc, phase, max_steps)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, s, p)))
    opt, scale = topt.make_optimizer(ttc, phase, max_steps, tm)
    named = dict(tm.named_parameters())
    rng = np.random.RandomState(5)
    for u in range(7):
        grads = jax.tree.map(lambda v: rng.randn(*np.shape(v)).astype(np.float32),
                             params)
        params, opt_state = update(grads, opt_state, params)
        for n, g in state_dict_from_jax(grads).items():
            named[n].grad = g
        topt.set_lrs(opt, scale, u)
        # the lr of update u, from the JAX package's schedule pieces
        for g in opt.param_groups:
            want = g["base_lr"]
            if phase == 1:
                want *= float(jopt.poly_schedule(1.0, budget, 0.9)(u))
                if kw:
                    want *= min((u + 1.0) / 3, 1.0)
            assert g["lr"] == pytest.approx(want, rel=1e-6), (u, g["label"])
        before = {n: p.detach().clone() for n, p in named.items()}
        opt.step()
        if phase == 1 and u >= budget:
            assert all(torch.equal(p, before[n]) for n, p in named.items())
            continue
        want_p = state_dict_from_jax(params)
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                       rtol=ADAM_RTOL, atol=1e-7,
                                       err_msg=f"{case} update {u}: {n}")


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.RandomState(6)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = topt.global_norm(got)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    topt.clip_by_global_norm(got, max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    if max_norm > float(norm):
        assert all(np.array_equal(g.numpy(), o) for g, o in zip(got, grads))
