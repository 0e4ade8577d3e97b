"""PyTorch port, U-Noise training: ``adlm_tpu_torch.train.unoise``, its
pipeline and the five U-Noise commands against the JAX package.

Both packages get the same weights (random flax trees through
``unet_state_dict_from_jax``) and the same ε (numpy values: on the JAX
side ``jax.random.normal`` is patched, on the port's the step takes
``eps``, or its ``draw_eps`` seam is patched).  Tolerances (f32):

* loss and ``mean_B``: atol ``LOSS_ATOL`` = 1e-5;
* gradients: rtol 2e-3, atol 1e-6 (``GRAD``).  Post-step parameters are
  not compared: Adam's first update is ±lr·sign(g), and the conv biases
  that feed a train-mode BN have an analytic gradient of 0 whose
  rounding noise takes either sign (tests/test_unet_golden.py:111-118);
  Adam itself is held against optax on shared gradients at atol 1e-6;
* running statistics after a step: rtol 1e-4, atol 1e-5;
* eval-step metrics: atol 1e-5;
* bf16 steps: loss within ``BF16_LOSS_ATOL`` = 2e-2 of the JAX bf16
  step's; gradients are held to the f32 gradients: their relative L2
  error must exceed 1e-3 (the step did round to bf16) and stay within
  ``BF16_GRAD_FACTOR`` = 1.5 times the JAX bf16 step's own error (about
  0.3 on these tiny random models, whose train-mode BN backward cancels
  large terms: bf16 keeps 8 bits, both round at every layer);
* ``--bf16`` on ``unoise-visualize`` and ``unoise-figures``: the
  importance map within ``BF16_B_ATOL`` = 2e-2 of the f32 command's, the
  figures' dice within ``CLI_DICE_ATOL``;
* the commands, on tiny arrays with ``--device cpu`` against the JAX
  CLI, from the same initial weights: the same files, validation losses
  within ``CLI_LOSS_ATOL`` = 5e-3 and dice (validation and the figures'
  sweep) within ``CLI_DICE_ATOL`` = 5e-2 after 2 epochs (Adam's sign on
  zero-gradient biases shifts what the eval-mode BN sees; the dice counts
  pixels whose logits sit near 0; measured: about 2e-3 and 2e-2), and
  ``prepare-unoise``'s arrays bit-equal.
"""

import csv
import json
import os
import pickle
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu import cli as jcli
from adlm_tpu.core.config import UNoiseConfig as JaxUNoiseConfig
from adlm_tpu.models.unet import UNet as JaxUNet
from adlm_tpu.ops import losses as jlosses
from adlm_tpu.train import unoise as ju

from adlm_tpu_torch import cli
from adlm_tpu_torch.core.config import UNoiseConfig
from adlm_tpu_torch.train import unoise as tu
from adlm_tpu_torch.train.optimizer import make_adam
from adlm_tpu_torch.utils.jax_weights import unet_state_dict_from_jax

from test_nifti import _write_decathlon
from test_torch_unet import random_unet_variables

LOSS_ATOL = 1e-5
GRAD = dict(rtol=2e-3, atol=1e-6)
STATS = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS_ATOL = 2e-2
BF16_GRAD_FACTOR = 1.5
CLI_LOSS_ATOL = 5e-3
CLI_DICE_ATOL = 5e-2
BF16_B_ATOL = 2e-2

UTIL = (3, 2)    # utility depth, channel factor
NOISE = (2, 2)   # noise
HW, B = 16, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(bf16=False):
    kw = dict(depth=NOISE[0], channel_factor=NOISE[1], util_depth=UTIL[0],
              util_channel_factor=UTIL[1], learning_rate=3e-3, noise_coeff=0.05,
              compute_dtype="bfloat16" if bf16 else "float32")
    return JaxUNoiseConfig(**kw), UNoiseConfig(**kw)


@pytest.fixture(scope="module")
def models():
    """JAX U-Nets with random variables: the utility and the noise model."""
    return {"util": random_unet_variables(*UTIL, seed=11),
            "noise": random_unet_variables(*NOISE, seed=12)}


def _batch(seed, raw):
    r = np.random.RandomState(seed)
    x = r.rand(B, HW, HW, 1 if raw else 3).astype(np.float32)
    y = (r.rand(B, HW, HW, 1) > 0.6).astype(np.float32)
    return x, y


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def assert_grads(got, jax_grads, **tol):
    want = unet_state_dict_from_jax(jax_grads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


def assert_stats(model, params, batch_stats):
    want = unet_state_dict_from_jax(params, batch_stats)
    got = model.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **STATS)


def _rel_l2(got, want):
    g = torch.cat([got[k].flatten() for k in want])
    w = torch.cat([want[k].flatten() for k in want])
    return float((g - w).norm() / w.norm())


def assert_bf16_grads(got, jax_bf16, jax_f32):
    f32 = unet_state_dict_from_jax(jax_f32)
    err, jax_err = _rel_l2(got, f32), _rel_l2(unet_state_dict_from_jax(jax_bf16), f32)
    assert all(bool(torch.isfinite(g).all()) and g.dtype == torch.float32
               for g in got.values())
    assert 1e-3 < err <= BF16_GRAD_FACTOR * jax_err, (err, jax_err)


# ---------------------------------------------------------------------------
# the utility model
# ---------------------------------------------------------------------------

def _jax_utility(cfg, params, bs, x, y, raw):
    """(new JAX state, loss, gradients) of one JAX utility step."""
    bf16 = cfg.compute_dtype == "bfloat16"
    model = JaxUNet(out_channels=1, depth=cfg.util_depth, cf=cfg.util_channel_factor)

    def lfn(p):
        fp = jax.tree.map(lambda v: v.astype(jnp.bfloat16), p) if bf16 else p
        logits, _ = model.apply({"params": fp, "batch_stats": bs},
                                ju._prep_images(jnp.asarray(x), raw, bf16), train=True,
                                mutable=["batch_stats"])
        return jlosses.bce_with_logits(logits, jnp.asarray(y))

    grads = jax.grad(lfn)(params)
    state = ju.init_utility_state(cfg, jax.random.PRNGKey(0),
                                  jnp.zeros((1, HW, HW, 3), jnp.float32))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, bs))
    new, loss = ju.make_utility_train_step(cfg, raw=raw)(state, jnp.asarray(x), jnp.asarray(y))
    return new, float(loss), grads


def _port_utility(cfg, params, bs):
    state = tu.init_utility_state(cfg, device="cpu")
    state.model.load_state_dict(unet_state_dict_from_jax(params, bs))
    return state


@pytest.mark.parametrize("raw", [False, True])
def test_utility_train_step_matches_jax(models, raw):
    jcfg, tcfg = _cfgs()
    _, params, bs = models["util"]
    x, y = _batch(1, raw)
    jnew, jloss, jgrads = _jax_utility(jcfg, params, bs, x, y, raw)
    state = _port_utility(tcfg, params, bs)
    loss = tu.make_utility_train_step(tcfg, raw=raw)(state, torch.from_numpy(x),
                                                      torch.from_numpy(y))
    assert abs(float(loss) - jloss) < LOSS_ATOL
    assert_grads(_grads(state.model), jgrads, **GRAD)
    assert_stats(state.model, params, jnew.batch_stats)
    assert state.step == 1 and int(jnew.step) == 1


@pytest.mark.parametrize("raw", [False, True])
def test_utility_eval_step_matches_jax(models, raw):
    jcfg, tcfg = _cfgs()
    _, params, bs = models["util"]
    x, y = _batch(2, raw)
    state = ju.init_utility_state(jcfg, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)))
    state = state.replace(params=params, batch_stats=bs)
    want = ju.make_utility_eval_step(jcfg, raw=raw)(state, jnp.asarray(x), jnp.asarray(y))
    got = tu.make_utility_eval_step(tcfg, raw=raw)(_port_utility(tcfg, params, bs),
                                                    torch.from_numpy(x), torch.from_numpy(y))
    for k in ("val_loss", "val_dice"):
        assert abs(float(got[k]) - float(want[k])) < LOSS_ATOL, k


def test_utility_bf16_step_within_bf16_rounding(models):
    jcfg, tcfg = _cfgs(bf16=True)
    _, params, bs = models["util"]
    x, y = _batch(3, True)
    jnew, jloss, jgrads = _jax_utility(jcfg, params, bs, x, y, True)
    _, _, jgrads32 = _jax_utility(_cfgs()[0], params, bs, x, y, True)
    state = _port_utility(tcfg, params, bs)
    loss = tu.make_utility_train_step(tcfg, raw=True)(state, torch.from_numpy(x),
                                                       torch.from_numpy(y))
    assert np.isfinite(float(loss))
    assert abs(float(loss) - jloss) < BF16_LOSS_ATOL
    assert_bf16_grads(_grads(state.model), jgrads, jgrads32)
    assert all(b.dtype == torch.float32 for b in state.model.buffers())
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_adam_matches_optax_on_shared_gradients():
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(5, 4).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    tx = optax.adam(3e-3, eps=1e-8)
    jp = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_adam(tp.values(), 3e-3)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)


# ---------------------------------------------------------------------------
# the noise model
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_eps(monkeypatch):
    """``jax.random.normal`` returning the test's numpy ε (cast to the
    requested dtype, as JAX draws it in B's dtype)."""
    box = {}

    def normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == box["eps"].shape
        return jnp.asarray(box["eps"], dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    return box


def _jax_noise(cfg, models, x, y, raw):
    """(new JAX state, metrics, gradients) of one JAX noise step."""
    bf16 = cfg.compute_dtype == "bfloat16"
    _, up, ubs = models["util"]
    _, npar, nbs = models["noise"]
    util_model = JaxUNet(out_channels=1, depth=cfg.util_depth, cf=cfg.util_channel_factor)
    key = jax.random.PRNGKey(5)
    cast = (lambda t: jax.tree.map(lambda v: v.astype(jnp.bfloat16), t)) if bf16 else (
        lambda t: t)

    def lfn(p):
        xx = ju._prep_images(jnp.asarray(x), raw, bf16)
        noise, Bm, _ = ju.noise_forward(cfg, cast(p), nbs, xx, key, True)
        pred = util_model.apply({"params": cast(up), "batch_stats": ubs}, xx + noise,
                                train=False)
        return jlosses.bce_with_logits(pred, jnp.asarray(y)) - cfg.noise_coeff * jnp.mean(
            jnp.log(Bm.astype(jnp.float32)))

    grads = jax.grad(lfn)(npar)
    state = ju.init_noise_state(cfg, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
                                util=ju.FrozenUtility(up, ubs),
                                pretrained_params=npar, pretrained_batch_stats=nbs)
    new, m = ju.make_noise_train_step(cfg, raw=raw)(state, jnp.asarray(x), jnp.asarray(y), key)
    return new, {k: float(v) for k, v in m.items()}, grads


def _port_noise(cfg, models):
    _, up, ubs = models["util"]
    _, npar, nbs = models["noise"]
    return tu.init_noise_state(cfg, unet_state_dict_from_jax(up, ubs),
                               pretrained=unet_state_dict_from_jax(npar, nbs), device="cpu")


@pytest.mark.parametrize("raw", [False, True])
def test_noise_train_step_matches_jax(models, jax_eps, raw):
    jcfg, tcfg = _cfgs()
    x, y = _batch(4, raw)
    eps = np.random.RandomState(9).randn(B, HW, HW, 1).astype(np.float32)
    jax_eps["eps"] = eps
    jnew, jm, jgrads = _jax_noise(jcfg, models, x, y, raw)
    state = _port_noise(tcfg, models)
    util_before = {k: v.clone() for k, v in state.utility.state_dict().items()}
    m = tu.make_noise_train_step(tcfg, raw=raw)(state, torch.from_numpy(x),
                                                 torch.from_numpy(y), eps=torch.from_numpy(eps))
    assert abs(float(m["train_loss"]) - jm["train_loss"]) < LOSS_ATOL
    assert abs(float(m["mean_B"]) - jm["mean_B"]) < LOSS_ATOL
    assert 0.0 < float(m["mean_B"]) < 1.0
    assert_grads(_grads(state.model), jgrads, **GRAD)
    assert_stats(state.model, jnew.params, jnew.batch_stats)
    # the frozen utility: no gradients, nothing changed
    assert all(p.grad is None for p in state.utility.parameters())
    for k, v in state.utility.state_dict().items():
        torch.testing.assert_close(v, util_before[k], rtol=0, atol=0)


def test_noise_eval_step_matches_jax(models, jax_eps):
    jcfg, tcfg = _cfgs()
    x, y = _batch(5, True)
    eps = np.random.RandomState(10).randn(B, HW, HW, 1).astype(np.float32)
    jax_eps["eps"] = eps
    _, up, ubs = models["util"]
    _, npar, nbs = models["noise"]
    jstate = ju.init_noise_state(jcfg, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
                                 util=ju.FrozenUtility(up, ubs),
                                 pretrained_params=npar, pretrained_batch_stats=nbs)
    want = ju.make_noise_eval_step(jcfg, raw=True)(jstate, jnp.asarray(x), jnp.asarray(y),
                                                   jax.random.PRNGKey(1))
    got = tu.make_noise_eval_step(tcfg, raw=True)(_port_noise(tcfg, models),
                                                   torch.from_numpy(x), torch.from_numpy(y),
                                                   eps=torch.from_numpy(eps))
    for k in ("val_loss", "val_dice"):
        assert abs(float(got[k]) - float(want[k])) < LOSS_ATOL, k


def test_noise_bf16_step_within_bf16_rounding(models, jax_eps):
    jcfg, tcfg = _cfgs(bf16=True)
    x, y = _batch(6, True)
    eps = np.random.RandomState(11).randn(B, HW, HW, 1).astype(np.float32)
    jax_eps["eps"] = eps
    _, jm, jgrads = _jax_noise(jcfg, models, x, y, True)
    _, _, jgrads32 = _jax_noise(_cfgs()[0], models, x, y, True)
    state = _port_noise(tcfg, models)
    m = tu.make_noise_train_step(tcfg, raw=True)(state, torch.from_numpy(x),
                                                  torch.from_numpy(y), eps=torch.from_numpy(eps))
    assert abs(float(m["train_loss"]) - jm["train_loss"]) < BF16_LOSS_ATOL
    assert abs(float(m["mean_B"]) - jm["mean_B"]) < BF16_LOSS_ATOL
    assert_bf16_grads(_grads(state.model), jgrads, jgrads32)


def test_noise_regularizer_stays_finite_where_b_underflows(models, jax_eps):
    """A noise head far below 0 drives B = σ(logits) to 0 in f32: the
    port's log B (logsigmoid of the logits) stays finite, with finite
    gradients; the JAX package's log(B) is −inf (ROADMAP.md, Queue 3)."""
    jcfg, tcfg = _cfgs()
    x, y = _batch(8, True)
    jax_eps["eps"] = np.random.RandomState(12).randn(B, HW, HW, 1).astype(np.float32)
    _, up, ubs = models["util"]
    _, npar, nbs = models["noise"]
    npar = {**npar, "head": {"kernel": npar["head"]["kernel"],
                             "bias": npar["head"]["bias"] - 200.0}}
    low = {"util": models["util"], "noise": (None, npar, nbs)}
    jstate = ju.init_noise_state(jcfg, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3)),
                                 util=ju.FrozenUtility(up, ubs),
                                 pretrained_params=npar, pretrained_batch_stats=nbs)
    want = ju.make_noise_eval_step(jcfg, raw=True)(jstate, jnp.asarray(x), jnp.asarray(y),
                                                   jax.random.PRNGKey(1))
    assert float(want["val_loss"]) == np.inf
    eps = torch.from_numpy(jax_eps["eps"])
    got = tu.make_noise_eval_step(tcfg, raw=True)(_port_noise(tcfg, low), torch.from_numpy(x),
                                                   torch.from_numpy(y), eps=eps)
    assert np.isfinite(float(got["val_loss"])) and float(got["val_loss"]) > 0.05 * 150
    state = _port_noise(tcfg, low)
    m = tu.make_noise_train_step(tcfg, raw=True)(state, torch.from_numpy(x),
                                                  torch.from_numpy(y), eps=eps)
    assert np.isfinite(float(m["train_loss"])) and float(m["mean_B"]) < 1e-30
    assert all(bool(torch.isfinite(g).all()) for g in _grads(state.model).values())


def test_noise_init_carries_pretrained_params_and_stats(models):
    _, tcfg = _cfgs()
    _, npar, nbs = models["noise"]
    state = _port_noise(tcfg, models)
    want = unet_state_dict_from_jax(npar, nbs)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    # without it: flax's initializers from the seed, statistics 0 / 1
    fresh = tu.init_noise_state(tcfg, state.utility.state_dict(), seed=0, device="cpu")
    assert float(fresh.model.downs[0][1].running_var.min()) == 1.0
    assert not state.utility.training and not any(
        p.requires_grad for p in state.utility.parameters())


def test_drawn_eps_is_seeded_and_in_b_dtype(models):
    _, tcfg = _cfgs()
    state = _port_noise(tcfg, models)
    x = tu._prep_images(torch.from_numpy(_batch(7, True)[0]), True)
    draws = []
    for dtype in (torch.float32, torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            noise, Bm, log_b = tu.noise_forward(tcfg, state.model, x, False, generator=g,
                                                dtype=dtype)
        assert noise.dtype == Bm.dtype == dtype and noise.shape == (B, 1, HW, HW)
        assert log_b.dtype == torch.float32
        draws.append(noise.float())
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the five commands against the JAX CLI
# ---------------------------------------------------------------------------

CLI_HW, CLI_N = 32, 30


def _shape_eps(shape_nhwc):
    """A numpy ε that depends only on the shape (the JAX step is traced
    once per shape, so its patched draw is too)."""
    seed = int(np.prod(shape_nhwc)) % (2 ** 31)
    return np.random.RandomState(seed).randn(*shape_nhwc).astype(np.float32)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, models):
    """Both CLIs' utility and noise runs on the same arrays, from the same
    initial weights and ε."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("unoise_cli")
    r = np.random.RandomState(0)
    data = root / "data"
    data.mkdir()
    yy, xx = np.mgrid[0:CLI_HW, 0:CLI_HW]
    imgs, masks = [], []
    for i in range(CLI_N):   # a bright blob to segment, over noise
        cy, cx = r.randint(8, CLI_HW - 8, size=2)
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r.randint(16, 40)
        imgs.append(np.clip(0.3 * r.rand(CLI_HW, CLI_HW) + 0.6 * blob, 0, 1))
        masks.append(blob)
    np.save(data / "images.npy", np.stack(imgs).astype(np.float32))
    np.save(data / "masks.npy", np.stack(masks).astype(np.float32))
    np.save(data / "bounding_boxes.npy", np.zeros((CLI_N, 4), np.int32))
    arrays = ["--imgs", str(data / "images.npy"), "--masks", str(data / "masks.npy"),
              "--boxes", str(data / "bounding_boxes.npy")]

    def jax_init(depth, cf):
        v = JaxUNet(out_channels=1, depth=depth, cf=cf).init(
            jax.random.PRNGKey(0), jnp.zeros((1, CLI_HW, CLI_HW, 3)), train=True)
        return unet_state_dict_from_jax(jax.tree.map(np.asarray, v["params"]),
                                        jax.tree.map(np.asarray, v["batch_stats"]))

    build = tu.build_unet

    def build_from_jax_init(depth, cf, device, seed=0, state_dict=None):
        return build(depth, cf, device, seed,
                     jax_init(depth, cf) if state_dict is None else state_dict)

    def jax_normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(_shape_eps(tuple(shape)), dtype)

    def port_eps(shape, generator, device, dtype):
        b, _, h, w = shape
        return torch.from_numpy(_shape_eps((b, h, w, 1))).reshape(shape).to(device, dtype)

    mp.setattr(tu, "build_unet", build_from_jax_init)
    mp.setattr(jax.random, "normal", jax_normal)
    mp.setattr(tu, "draw_eps", port_eps)
    arch = ["--depth", "2", "--channel-factor", "2", "--epochs", "2", "--batch-size", "4"]
    out = {}
    try:
        for pkg, main, extra in (("jax", jcli.main, []), ("torch", cli.main, ["--device", "cpu"])):
            results = root / pkg
            mp.setenv("RESULTS_DIR", str(results))
            main(["unoise-train-util", *arrays, *arch, "--run-name", "util", *extra])
            main(["unoise-train-noise", *arrays, *arch, "--run-name", "noise",
                  "--utility-run", "util", "--pretrained", "util", *extra])
            main(["unoise-visualize", *arrays, "--utility-run", "util", "--noise-run", "noise",
                  "--occlusion-stride", "8", *extra])
            main(["unoise-figures", *arrays, "--utility-run", "util", "--noise-runs", "noise",
                  "--n-images", "3", "--save-pickle", str(results / "results.pickle"), *extra])
            out[pkg] = results
    finally:
        mp.undo()
    return out


def _files(run_dir):
    """Relative paths of a run directory, a checkpoint directory standing
    for its content (each package writes its own payload format)."""
    out = set()
    for dirpath, dirnames, filenames in os.walk(run_dir):
        rel = os.path.relpath(dirpath, run_dir)
        if os.path.basename(os.path.dirname(dirpath)) == "checkpoints":
            out.add(rel)
            dirnames.clear()
            continue
        if "tb" in rel.split(os.sep):
            continue
        out.update(os.path.normpath(os.path.join(rel, f)) for f in filenames)
    return out


def _metrics(run_dir, name):
    with open(os.path.join(run_dir, "logs", f"{name}_metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_cli_writes_the_jax_files(cli_runs):
    for run in ("util", "noise"):
        got, want = _files(cli_runs["torch"] / run), _files(cli_runs["jax"] / run)
        assert got == want, (run, got ^ want)
    vis = cli_runs["torch"] / "noise" / "visualizations"
    assert len([f for f in os.listdir(vis) if f.startswith("threshold_")]) == 11
    with open(vis / "timing.json") as f:
        assert set(json.load(f)) == {"unoise", "grad_cam", "occlusion"}
    for pkg in ("jax", "torch"):
        with open(cli_runs[pkg] / "util" / "utility_config.json") as f:
            assert json.load(f) == {"depth": 2, "channel_factor": 2}


@pytest.mark.parametrize("run,name", [("util", "unoise_util"), ("noise", "unoise_noise")])
def test_cli_validation_metrics_match_jax(cli_runs, run, name):
    got = _metrics(cli_runs["torch"] / run, name)
    want = _metrics(cli_runs["jax"] / run, name)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.isfinite(float(g["val_loss"]))
        assert abs(float(g["val_loss"]) - float(w["val_loss"])) < CLI_LOSS_ATOL, (g, w)
        assert abs(float(g["val_dice"]) - float(w["val_dice"])) < CLI_DICE_ATOL, (g, w)


def test_cli_figures_pickle_matches_jax(cli_runs):
    with open(cli_runs["torch"] / "results.pickle", "rb") as f:
        got = pickle.load(f)["noise"]
    with open(cli_runs["jax"] / "results.pickle", "rb") as f:
        want = pickle.load(f)["noise"]
    assert set(got) == set(want)
    assert got["num_params"] == want["num_params"]
    np.testing.assert_array_equal(got["thresholds"], want["thresholds"])
    assert len(got["dice"]) == len(got["coverage"]) == 21
    np.testing.assert_allclose(got["dice"], want["dice"], atol=CLI_DICE_ATOL)
    np.testing.assert_allclose(got["dice_at_half_coverage"], want["dice_at_half_coverage"],
                               atol=CLI_DICE_ATOL)
    assert 0.0 <= got["dice_at_half_coverage"] <= 1.0


def test_noise_training_from_reference_lightning_checkpoints(cli_runs, tmp_path, monkeypatch):
    """``--utility-torch-ckpt`` and ``--pretrained-torch-ckpt`` read a
    reference-style lightning file (the U-Net under ``model.``): the frozen
    utility is that file's model, and a file of another architecture is
    refused for the noise init."""
    from adlm_tpu_torch.core.checkpoint import CheckpointStore

    sd = CheckpointStore(str(cli_runs["torch"] / "util")).restore("utility", "best")["state_dict"]
    ckpt = tmp_path / "utility.ckpt"
    torch.save({"epoch": 1, "state_dict": {"model." + k: v for k, v in sd.items()}}, ckpt)
    data = cli_runs["torch"].parent / "data"
    arrays = ["--imgs", str(data / "images.npy"), "--masks", str(data / "masks.npy"),
              "--boxes", str(data / "bounding_boxes.npy")]
    monkeypatch.setenv("RESULTS_DIR", str(tmp_path / "runs"))
    seen = {}
    build = tu.build_unet

    def recording(depth, cf, device, seed=0, state_dict=None):
        model = build(depth, cf, device, seed, state_dict)
        seen.setdefault("models", []).append((depth, cf, state_dict is not None))
        return model

    monkeypatch.setattr(tu, "build_unet", recording)
    cli.main(["unoise-train-noise", *arrays, "--run-name", "n", "--depth", "2",
              "--channel-factor", "2", "--epochs", "1", "--batch-size", "4",
              "--utility-torch-ckpt", str(ckpt), "--pretrained-torch-ckpt", str(ckpt),
              "--device", "cpu"])
    # the noise model and the frozen utility, both from the file
    assert seen["models"] == [(2, 2, True), (2, 2, True)]
    log = (tmp_path / "runs" / "n" / "logs" / "unoise_noise.log").read_text()
    assert "from torch checkpoint" in log and "(depth 2, cf 2)" in log
    with pytest.raises(SystemExit, match="does not match"):
        cli.main(["unoise-train-noise", *arrays, "--run-name", "m", "--depth", "3",
                  "--channel-factor", "2", "--epochs", "1", "--utility-torch-ckpt", str(ckpt),
                  "--pretrained-torch-ckpt", str(ckpt), "--device", "cpu"])


def test_bf16_interpretation_commands_within_bf16_rounding(cli_runs, tmp_path, monkeypatch):
    """``--bf16`` on ``unoise-visualize`` and ``unoise-figures`` casts the
    trained U-Nets' parameters to bf16 (the BN statistics stay f32): the
    importance map moves off the f32 command's, by at most
    ``BF16_B_ATOL`` = 2e-2, and the figures' dice stay within
    ``CLI_DICE_ATOL`` of the f32 command's (measured: 6.3e-3 and 2.2e-3)."""
    from adlm_tpu_torch.interpret import unoise_vis as tvis

    results = tmp_path / "runs"
    shutil.copytree(cli_runs["torch"], results)
    data = cli_runs["torch"].parent / "data"
    arrays = ["--imgs", str(data / "images.npy"), "--masks", str(data / "masks.npy"),
              "--boxes", str(data / "bounding_boxes.npy")]
    monkeypatch.setenv("RESULTS_DIR", str(results))
    maps, importance = [], tvis.unoise_importance

    def recording(model, images):
        maps.append(importance(model, images))
        return maps[-1]

    monkeypatch.setattr(tvis, "unoise_importance", recording)
    figures = {}
    for dtype, flag in (("f32", []), ("bf16", ["--bf16"])):
        maps.clear()
        cli.main(["unoise-visualize", *arrays, "--utility-run", "util", "--noise-run", "noise",
                  "--occlusion-stride", "8", "--device", "cpu", *flag])
        figures[dtype] = maps[0]
        pkl = str(results / f"{dtype}.pickle")
        cli.main(["unoise-figures", *arrays, "--utility-run", "util", "--noise-runs", "noise",
                  "--n-images", "3", "--save-pickle", pkl, "--device", "cpu", *flag])
        with open(pkl, "rb") as f:
            figures[dtype + "_pickle"] = pickle.load(f)["noise"]
    diff = np.abs(figures["bf16"] - figures["f32"]).max()
    assert 0.0 < diff <= BF16_B_ATOL, diff
    got, want = figures["bf16_pickle"], figures["f32_pickle"]
    assert np.all(np.isfinite(got["dice"])) and len(got["dice"]) == 21
    np.testing.assert_allclose(got["dice"], want["dice"], atol=CLI_DICE_ATOL)
    np.testing.assert_allclose(got["dice_at_half_coverage"], want["dice_at_half_coverage"],
                               atol=CLI_DICE_ATOL)


def test_prepare_unoise_through_both_clis(tmp_path):
    src = _write_decathlon(tmp_path / "src")
    jcli.main(["prepare-unoise", src, str(tmp_path / "j")])
    cli.main(["prepare-unoise", src, str(tmp_path / "t"), "--device", "cpu"])
    for name in ("images.npy", "masks.npy", "bounding_boxes.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                      np.load(tmp_path / "j" / name))


def test_figures_from_pickle_renders_without_checkpoints(cli_runs, tmp_path, monkeypatch,
                                                         capsys):
    monkeypatch.setenv("RESULTS_DIR", str(tmp_path))
    cli.main(["unoise-figures", "--from-pickle", str(cli_runs["jax"] / "results.pickle"),
              "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    with open(cli_runs["jax"] / "results.pickle", "rb") as f:
        want = pickle.load(f)["noise"]
    assert out == {"noise": {"num_params": want["num_params"],
                             "dice_at_half_coverage": want["dice_at_half_coverage"]}}
