"""PyTorch port, data parallelism: ``adlm_tpu_torch.parallel.sharding`` and
the mesh-aware steps on a 2-rank gloo world on the CPU, against the JAX
package's sharded functions on a 2-device mesh (``jax.devices()[:2]``;
tests/conftest.py forces 8 CPU devices).

One module fixture spawns the world (``core/mesh.py::spawn_local``, a
file store under ``tmp_path``, a 60 s collective timeout and a bound on
the whole run).  Each rank takes its slice of the same numpy inputs and
writes what it computed; the JAX package's sharded function runs on the
whole batch here.  This module imports no JAX at its top: the spawned
ranks import it.  Cases and tolerances (those of the single-device port
tests):

* the ProtoSeg window (``make_sharded_train_step``), plain and fused, on
  labels whose rank halves have different void shares (one rank half
  of a microbatch all void): metrics at ``METRIC_RTOL``, ``n_correct``
  within ``TIE_BUDGET``, each parameter's update within ``UPDATE_RTOL``
  (tests/test_torch_train.py), the two ranks' parameters bit-equal, and
  the naive control (the mean of the ranks' own means) off by more than
  ``METRIC_RTOL``;
* the U-Noise utility and noise steps (``make_sharded_utility_step``,
  ``make_sharded_noise_step``, ε given at the global shape): losses at
  ``LOSS_ATOL``, gradients at ``GRAD``, BN running statistics at
  ``STATS`` (tests/test_torch_unoise.py);
* the classifier's joint step on the ResNet-18 stem of
  tests/test_torch_classification.py (``FlaxBatchNorm``, global
  statistics): its ``LOSS_RTOL``, ``GRAD_RTOL`` and ``STATS``;
* batch-sharded eval (``SegEvaluator(mesh=...)``, grid and upsampled
  statistics) over 3 images at batch 2, whose padded tail leaves one
  rank nothing to do: tests/test_torch_evaluate.py's budgets (the void
  total exact, the other counters and the nearest counts within
  ``EVAL_TIE_BUDGET`` flipped pixels, purity within 1e-3), and every
  rank holding the same totals;
* the batched push over 4 frames, frame 0 repeated as frame 2 on the
  other rank: the winners equal to JAX's ``make_push_batched_fn`` on
  the sharded batch, ties to frame 0;
* spatial eval: the same world as a (data 1, model 2) mesh (a second
  ``Mesh`` over the same group), ``SegEvaluator`` with grid and upsampled
  statistics over 3 frames of 64x64 at batch 2 (a padded tail), whose 9
  grid rows split 4 + 5: against the JAX package's
  ``make_sharded_inference_fn(spatial=True)`` on a (1, 2) device mesh
  and against the port's one-process eval, with the eval budgets above,
  and every rank holding the same totals; the same for the MSC model
  (``msc_scales`` (0.5, 0.75), the same weights: MSC adds none), whose
  pyramid grids of 5 and 7 rows split 2 + 3 and 3 + 4;
* the tensor-parallel prototype head on the same (data 1, model 2)
  ranks (``prototype_parallel_params``: 6 of the 12 prototypes each;
  ``make_sharded_inference_fn(spatial=False, prototype_parallel=True)``)
  with grid and upsampled statistics on 4 frames of 64x64, against the
  JAX package's ``make_sharded_inference_fn(spatial=False,
  prototype_parallel=True)`` fed its ``prototype_parallel_params`` on a
  (1, 2) device mesh, with tests/test_parallel.py's assertions:
  counters, ``nearest_proto`` and ``agree_counts`` equal, purity at
  ``TP_PURITY``; against the port's one-process eval the same; every
  rank the same outputs; and with ``spatial=True`` too (the bank
  gathered over the ranks), equal to spatial eval with the whole bank.
"""

import os

import numpy as np
import pytest
import torch

from adlm_tpu_torch.core import config as tcfg_mod
from adlm_tpu_torch.core.mesh import MeshSpec, destroy, make_mesh, spawn_local

WORLD = 2
COLLECTIVE_TIMEOUT_S = 60.0
RUN_TIMEOUT_S = 240.0

METRIC_RTOL = 1e-4
UPDATE_RTOL = 1e-3
TIE_BUDGET = 1
LOSS_ATOL = 1e-5
GRAD = dict(rtol=2e-3, atol=1e-6)
STATS = dict(rtol=1e-4, atol=1e-5)
CLS_LOSS_RTOL = 1e-4
CLS_GRAD_RTOL = 1e-4
PURITY_ATOL = 1e-3

PROTOSEG_MODEL = dict(num_prototypes=6, num_classes=3, prototype_channels=8,
                      deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1),
                      img_size=33, add_on_layers_type="regular")
# test_torch_models.TINY (that module imports JAX, which the ranks must not)
EVAL_MODEL = dict(num_prototypes=12, num_classes=4, prototype_channels=16,
                  deeplab_n_features=16, deeplab_n_blocks=(1, 1, 1, 1))
EVAL_TIE_BUDGET = 4   # tests/test_torch_evaluate.py's TIE_BUDGET
MSC_SCALES = (0.5, 0.75)
TP_PURITY = dict(rtol=1e-5, atol=1e-6)   # tests/test_parallel.py's prototype-parallel test
TP_EXACT = ("intersection", "union", "correct", "total", "nearest_proto", "agree_counts")
UTIL, NOISE, UHW, UB = (2, 2), (2, 2), 16, 4
CLS_B, CLS_HW = 8, 32


def _protoseg_cfg(mod, fused):
    return mod.ExperimentConfig(
        name="tiny", model=mod.PPNetConfig(**PROTOSEG_MODEL),
        data=mod.DataConfig(window_size=(33, 33)),
        train=mod.TrainConfig(iter_size=2, loss_weight_kld=0.25,
                              fused_accumulation=fused))


def _unoise_cfg(cls):
    return cls(depth=NOISE[0], channel_factor=NOISE[1], util_depth=UTIL[0],
               util_channel_factor=UTIL[1], learning_rate=3e-3, noise_coeff=0.05)


def _cls_cfg(cls_cfg, ppnet_cfg):
    return cls_cfg(model=ppnet_cfg(base_architecture="resnet18", img_size=CLS_HW,
                                   num_prototypes=6, prototype_channels=16, num_classes=3,
                                   add_on_layers_type="regular",
                                   patch_classification=False))


# ---------------------------------------------------------------------------
# what each rank runs
# ---------------------------------------------------------------------------

def _named_grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _rank_protoseg(mesh, inp):
    from adlm_tpu_torch.models.ppnet import PPNet
    from adlm_tpu_torch.parallel.sharding import make_sharded_train_step
    from adlm_tpu_torch.train import protoseg as T

    images, labels = inp["ps_images"], inp["ps_labels"]
    rows = mesh.batch_slice(images.shape[1])
    out = {}
    for fused in (False, True):
        cfg = _protoseg_cfg(tcfg_mod, fused)
        model = PPNet(cfg.model)
        model.load_state_dict(inp["ps_sd"], strict=True)
        state = T.init_protoseg_state(model, cfg, 1, 6, device="cpu")
        step = make_sharded_train_step(model, cfg, 1, mesh, 6)
        _, metrics = step(state, images[:, rows], labels[:, rows])
        out[fused] = {"metrics": {k: float(v) for k, v in metrics.items()},
                      "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    # the naive control: this rank's own mean over the window, no mesh
    cfg = _protoseg_cfg(tcfg_mod, False)
    model = PPNet(cfg.model)
    model.load_state_dict(inp["ps_sd"], strict=True)
    pc = T.default_proto_class(6, 3)
    with torch.no_grad():
        own = [float(T.loss_fn(model, pc, cfg, (torch.from_numpy(images[i, rows]),
                                                 torch.from_numpy(labels[i, rows])), True)[0])
               for i in range(images.shape[0])]
    out["naive"] = float(np.mean(own))
    return out


def _rank_unoise(mesh, inp):
    from adlm_tpu_torch.core.config import UNoiseConfig
    from adlm_tpu_torch.parallel.sharding import (
        make_sharded_noise_step,
        make_sharded_utility_step,
    )
    from adlm_tpu_torch.train import unoise as tu

    cfg = _unoise_cfg(UNoiseConfig)
    rows = mesh.batch_slice(UB)
    x, y = inp["u_x"], inp["u_y"]
    util = tu.init_utility_state(cfg, device="cpu")
    util.model.load_state_dict(inp["util_sd"])
    loss = make_sharded_utility_step(cfg, mesh, raw=True)(
        util, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]))
    noise = tu.init_noise_state(cfg, inp["util_sd"], pretrained=inp["noise_sd"], device="cpu")
    m = make_sharded_noise_step(cfg, mesh, raw=True)(
        noise, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
        eps=torch.from_numpy(inp["u_eps"]))
    return {"util_loss": float(loss), "util_grads": _named_grads(util.model),
            "util_sd": util.model.state_dict(),
            "noise_metrics": {k: float(v) for k, v in m.items()},
            "noise_grads": _named_grads(noise.model), "noise_sd": noise.model.state_dict()}


def _rank_cls(mesh, inp):
    from adlm_tpu_torch.core.config import PPNetConfig
    from adlm_tpu_torch.models.ppnet import PPNet
    from adlm_tpu_torch.parallel.sharding import make_sharded_cls_step
    from adlm_tpu_torch.train import classification as tcls

    cfg = _cls_cfg(tcls.ClassificationConfig, PPNetConfig)
    model = PPNet(cfg.model)
    model.load_state_dict(inp["cls_sd"])
    state = tcls.init_classifier_state(model, cfg, "joint", 1, device="cpu")
    rows = mesh.batch_slice(CLS_B)
    _, m = make_sharded_cls_step(model, cfg, "joint", mesh)(
        state, inp["cls_images"][rows], inp["cls_labels"][rows])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": _named_grads(model), "sd": model.state_dict()}


def _eval_model(sd, msc=False):
    from adlm_tpu_torch.core.config import PPNetConfig
    from adlm_tpu_torch.models.ppnet import PPNet

    model = PPNet(PPNetConfig(**EVAL_MODEL, msc_scales=MSC_SCALES if msc else ()))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def eval_batches(images, labels, batch):
    """The padded batches of ``batch`` over the images, with n_real."""
    for s in range(0, len(images), batch):
        im, lb = images[s:s + batch], labels[s:s + batch]
        n = len(im)
        pad = batch - n
        yield (np.concatenate([im, np.zeros((pad,) + im.shape[1:], im.dtype)]),
               np.concatenate([lb, np.zeros((pad,) + lb.shape[1:], lb.dtype)]), n)


def _rank_eval(mesh, inp):
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator
    from adlm_tpu_torch.interpret.push import make_push_batched_fn
    from adlm_tpu_torch.models.ppnet import default_proto_class

    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    pc = default_proto_class(P, K)
    out = {}
    for upsampled in (False, True):
        ev = SegEvaluator(_eval_model(inp["ev_sd"]), K, with_stats=True,
                          stats_upsampled=upsampled, mesh=mesh)
        rows = []
        for im, lb, n in eval_batches(inp["ev_images"], inp["ev_labels"], 2):
            s = mesh.batch_slice(2)
            o = ev.update(pc, im[s], lb[s], n_valid=n)
            rows.append((o["agree_counts"][:n].clone(), o["topk_purity"][:n].clone()))
        out[upsampled] = {"intersection": ev.intersection, "union": ev.union,
                          "correct": ev.correct, "total": ev.total,
                          "agree": torch.cat([r[0] for r in rows]),
                          "purity": torch.cat([r[1] for r in rows])}
    fn = make_push_batched_fn(_eval_model(inp["ev_sd"]), K, device="cpu", mesh=mesh)
    s = mesh.batch_slice(4)
    out["push"] = [t.clone() for t in fn(pc, inp["push_images"][s], inp["push_labels"][s])]
    return out


def _spatial_eval(mesh, inp, device=None, msc=False):
    """SegEvaluator over the spatial frames (``mesh`` None: one process),
    grid and upsampled statistics: {upsampled: totals and statistic rows}."""
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator
    from adlm_tpu_torch.models.ppnet import default_proto_class

    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    pc = default_proto_class(P, K)
    out = {}
    for upsampled in (False, True):
        ev = SegEvaluator(_eval_model(inp["ev_sd"], msc), K, with_stats=True,
                          stats_upsampled=upsampled, mesh=mesh, device=device)
        rows = []
        for im, lb, n in eval_batches(inp["sp_images"], inp["sp_labels"], 2):
            o = ev.update(pc, im, lb, n_valid=n) if mesh is not None else ev.update(pc, im, lb)
            rows.append((o["agree_counts"][:n].clone(), o["topk_purity"][:n].clone()))
        out[upsampled] = {"intersection": ev.intersection, "union": ev.union,
                          "correct": ev.correct, "total": ev.total,
                          "agree": torch.cat([r[0] for r in rows]),
                          "purity": torch.cat([r[1] for r in rows])}
    return out


def _tp_keep(o):
    return {k: o[k].clone() for k in TP_EXACT + ("topk_purity", "pred")}


def _tp_eval(mesh, inp):
    """The tensor-parallel head on the 4 frames (``mesh`` None: the port's
    one-process eval with the whole bank): {upsampled: outputs}; with a
    mesh also {"spatial": (whole bank, gathered bank)} under spatial eval."""
    from adlm_tpu_torch.interpret.evaluate import make_inference_fn
    from adlm_tpu_torch.models.ppnet import default_proto_class
    from adlm_tpu_torch.parallel.sharding import (
        make_sharded_inference_fn,
        prototype_parallel_params,
    )

    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    pc = default_proto_class(P, K)
    args = (pc, inp["tp_images"], inp["tp_labels"], inp["tp_u"], inp["tp_v"])
    model = _eval_model(inp["ev_sd"])
    out = {}
    for upsampled in (False, True):
        if mesh is None:
            o = make_inference_fn(model, K, True, upsampled, device="cpu")(*args)
        else:
            fn = make_sharded_inference_fn(model, K, mesh, spatial=False, with_stats=True,
                                           prototype_parallel=True, stats_upsampled=upsampled)
            o = fn(prototype_parallel_params(model, mesh), *args)
        out[upsampled] = _tp_keep(o)
    if mesh is not None:
        whole = make_sharded_inference_fn(model, K, mesh, with_stats=True,
                                          stats_upsampled=True)(*args)
        tp = make_sharded_inference_fn(model, K, mesh, with_stats=True, prototype_parallel=True,
                                       stats_upsampled=True)(
            prototype_parallel_params(model, mesh), *args)
        out["spatial"] = (_tp_keep(whole), _tp_keep(tp))
    return out


def _rank_main(dev, mesh_args, in_path, out_dir):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(1)
    mesh = make_mesh(MeshSpec(WORLD, 1), dev, **mesh_args)
    # the same ranks as one data line whose model ranks split image H
    spatial = make_mesh(MeshSpec(1, WORLD), dev)
    inp = torch.load(in_path, weights_only=False)
    try:
        out = {"protoseg": _rank_protoseg(mesh, inp), "unoise": _rank_unoise(mesh, inp),
               "cls": _rank_cls(mesh, inp), "eval": _rank_eval(mesh, inp),
               "spatial": _spatial_eval(spatial, inp),
               "msc": _spatial_eval(spatial, inp, msc=True), "tp": _tp_eval(spatial, inp)}
    finally:
        destroy(mesh)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


# ---------------------------------------------------------------------------
# the inputs (JAX variables, here) and the world
# ---------------------------------------------------------------------------

def _protoseg_inputs():
    from test_torch_train import _configs, _pair

    jcfg, tcfg = _configs()
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=7)
    rng = np.random.RandomState(11)
    images = rng.rand(2, 4, 33, 33, 3).astype(np.float32)
    labels = rng.randint(0, 4, (2, 4, 33, 33)).astype(np.int32)
    labels[0, :2] = 0                       # rank 0's half of microbatch 0: all void
    labels[1, 2:, :, :24] = 0               # rank 1's half of microbatch 1: mostly void
    return dict(ps_images=images, ps_labels=labels, ps_sd=tm.state_dict(),
                ps_jax=(jm, params, constants))


def _unoise_inputs():
    from adlm_tpu_torch.utils.jax_weights import unet_state_dict_from_jax

    from test_torch_unet import random_unet_variables

    util = random_unet_variables(*UTIL, seed=11, hw=UHW)
    noise = random_unet_variables(*NOISE, seed=12, hw=UHW)
    r = np.random.RandomState(1)
    return dict(u_x=r.rand(UB, UHW, UHW, 1).astype(np.float32),
                u_y=(r.rand(UB, UHW, UHW, 1) > 0.6).astype(np.float32),
                u_eps=r.randn(UB, UHW, UHW, 1).astype(np.float32),
                util_sd=unet_state_dict_from_jax(util[1], util[2]),
                noise_sd=unet_state_dict_from_jax(noise[1], noise[2]),
                u_jax=(util, noise))


def _cls_inputs():
    import jax

    from adlm_tpu.core.config import PPNetConfig as JaxPPNetConfig
    from adlm_tpu.models.ppnet import PPNet as JaxPPNet
    from adlm_tpu.train import classification as jcls

    from adlm_tpu_torch.utils.jax_weights import cls_state_dict_from_jax

    jcfg = _cls_cfg(jcls.ClassificationConfig, JaxPPNetConfig)
    model = JaxPPNet(cfg=jcfg.model)
    rng = np.random.RandomState(1)
    images = rng.randn(CLS_B, CLS_HW, CLS_HW, 3).astype(np.float32)
    labels = (np.arange(CLS_B) % 3).astype(np.int32)
    v = jax.jit(lambda key, x: model.init(key, x, train=True))(jax.random.PRNGKey(0), images)
    params = jax.tree.map(np.asarray, v["params"])
    bs = jax.tree.map(np.asarray, v["batch_stats"])
    return dict(cls_images=images, cls_labels=labels,
                cls_sd=cls_state_dict_from_jax(params, bs, "resnet18"),
                cls_jax=(jcfg, model, params, bs))


def _eval_inputs():
    from test_torch_models import TINY, jax_pair
    from test_torch_push import block_labels

    assert TINY == EVAL_MODEL
    jm, params, constants, tm = jax_pair(seed=5)
    rng = np.random.RandomState(3)
    K = TINY["num_classes"]
    ev_images = rng.rand(3, 65, 97, 3).astype(np.float32)
    ev_labels = rng.randint(0, K + 1, (3, 65, 97)).astype(np.int32)
    frames = rng.rand(4, 65, 97, 3).astype(np.float32)
    frames[2] = frames[0]
    flabels = np.stack(list(block_labels(rng, 4, 65, 97, K)))[:, 0]
    flabels[2] = flabels[0]
    sp_images = rng.rand(3, 64, 64, 3).astype(np.float32)
    sp_labels = rng.randint(0, K + 1, (3, 64, 64)).astype(np.int32)
    sp_labels[1, 30:34] = 0                 # void across the ranks' row boundary
    tp_images = rng.rand(4, 64, 64, 3).astype(np.float32)
    tp_labels = rng.randint(0, K + 1, (4, 64, 64)).astype(np.int32)
    tp_u, tp_v = (rng.random_sample((4, 16)).astype(np.float32) for _ in range(2))
    return dict(ev_images=ev_images, ev_labels=ev_labels, ev_sd=tm.state_dict(),
                push_images=frames, push_labels=flabels.astype(np.int32),
                sp_images=sp_images, sp_labels=sp_labels, tp_images=tp_images,
                tp_labels=tp_labels, tp_u=tp_u, tp_v=tp_v, ev_jax=(jm, params, constants))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the inputs, ``ranks()``): the world runs in a thread while the
    tests compute their JAX references; ``ranks()`` waits for it and
    returns what each rank computed."""
    import threading

    root = tmp_path_factory.mktemp("world")
    inp = {**_protoseg_inputs(), **_unoise_inputs(), **_cls_inputs(), **_eval_inputs()}
    in_path = str(root / "inputs.pt")
    torch.save({k: v for k, v in inp.items() if not k.endswith("_jax")}, in_path)
    box = {}

    def run():
        box["codes"] = spawn_local(_rank_main, WORLD, str(root / "store"), ["cpu"] * WORLD,
                                   args=(in_path, str(root)),
                                   timeout_s=COLLECTIVE_TIMEOUT_S,
                                   join_timeout=RUN_TIMEOUT_S)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def ranks():
        if "ranks" not in box:
            thread.join(RUN_TIMEOUT_S + 30)
            assert box.get("codes") == [0] * WORLD, box.get("codes")
            box["ranks"] = [torch.load(str(root / f"rank{r}.pt"), weights_only=False)
                            for r in range(WORLD)]
        return box["ranks"]

    yield inp, ranks
    thread.join(RUN_TIMEOUT_S + 30)


def _jax_mesh():
    import jax

    from adlm_tpu.core.mesh import MeshSpec as JaxMeshSpec, make_mesh as jax_make_mesh

    return jax_make_mesh(JaxMeshSpec(data=WORLD, model=1), devices=jax.devices()[:WORLD])


# ---------------------------------------------------------------------------
# U-Noise
# ---------------------------------------------------------------------------

def _unet_sd(params, bs=None):
    from adlm_tpu_torch.utils.jax_weights import unet_state_dict_from_jax

    return unet_state_dict_from_jax(params, bs)


def test_sharded_utility_step_matches_jax(world):
    import jax
    import jax.numpy as jnp

    from adlm_tpu.core.config import UNoiseConfig as JaxUNoiseConfig
    from adlm_tpu.models.unet import UNet as JaxUNet
    from adlm_tpu.ops import losses as jlosses
    from adlm_tpu.parallel.sharding import make_sharded_utility_step, shard_state
    from adlm_tpu.train import unoise as ju

    inp, get_ranks = world
    (_, params, bs), _ = inp["u_jax"]
    cfg = _unoise_cfg(JaxUNoiseConfig)
    x, y = jnp.asarray(inp["u_x"]), jnp.asarray(inp["u_y"])
    model = JaxUNet(out_channels=1, depth=cfg.util_depth, cf=cfg.util_channel_factor)

    def lfn(p):
        logits, _ = model.apply({"params": p, "batch_stats": bs}, ju._prep_images(x, True, False),
                                train=True, mutable=["batch_stats"])
        return jlosses.bce_with_logits(logits, y)

    grads = _unet_sd(jax.jit(jax.grad(lfn))(params))
    st = ju.init_utility_state(cfg, jax.random.PRNGKey(0), jnp.zeros((1, UHW, UHW, 3)))
    st = shard_state(st.replace(params=params, batch_stats=bs), _jax_mesh())
    new, loss = make_sharded_utility_step(cfg, _jax_mesh(), raw=True)(st, x, y)
    stats = _unet_sd(new.params, new.batch_stats)
    ranks = get_ranks()
    for r, res in enumerate(ranks):
        u = res["unoise"]
        assert abs(u["util_loss"] - float(loss)) < LOSS_ATOL, r
        for k, g in grads.items():
            np.testing.assert_allclose(u["util_grads"][k].numpy(), g.numpy(), err_msg=k, **GRAD)
        for k, v in stats.items():
            if "running" in k:
                np.testing.assert_allclose(u["util_sd"][k].numpy(), v.numpy(), err_msg=k,
                                           **STATS)
    for k, v in ranks[0]["unoise"]["util_sd"].items():
        assert torch.equal(v, ranks[1]["unoise"]["util_sd"][k]), k


def test_sharded_noise_step_matches_jax(world, monkeypatch):
    import jax
    import jax.numpy as jnp

    from adlm_tpu.core.config import UNoiseConfig as JaxUNoiseConfig
    from adlm_tpu.models.unet import UNet as JaxUNet
    from adlm_tpu.ops import losses as jlosses
    from adlm_tpu.parallel.sharding import make_sharded_noise_step, shard_state
    from adlm_tpu.train import unoise as ju

    inp, get_ranks = world
    (_, up, ubs), (_, npar, nbs) = inp["u_jax"]
    eps = inp["u_eps"]
    # JAX draws ε at the global shape inside its step: hand it the test's
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    cfg = _unoise_cfg(JaxUNoiseConfig)
    x, y = jnp.asarray(inp["u_x"]), jnp.asarray(inp["u_y"])
    util = JaxUNet(out_channels=1, depth=cfg.util_depth, cf=cfg.util_channel_factor)
    key = jax.random.PRNGKey(5)

    def lfn(p):
        xx = ju._prep_images(x, True, False)
        noise, Bm, _ = ju.noise_forward(cfg, p, nbs, xx, key, True)
        pred = util.apply({"params": up, "batch_stats": ubs}, xx + noise, train=False)
        return jlosses.bce_with_logits(pred, y) - cfg.noise_coeff * jnp.mean(
            jnp.log(Bm.astype(jnp.float32)))

    grads = _unet_sd(jax.jit(jax.grad(lfn))(npar))
    st = ju.init_noise_state(cfg, jax.random.PRNGKey(0), jnp.zeros((1, UHW, UHW, 3)),
                             util=ju.FrozenUtility(up, ubs), pretrained_params=npar,
                             pretrained_batch_stats=nbs)
    st = shard_state(st, _jax_mesh())
    new, m = make_sharded_noise_step(cfg, _jax_mesh(), raw=True)(st, x, y, key)
    stats = _unet_sd(new.params, new.batch_stats)
    ranks = get_ranks()
    for r, res in enumerate(ranks):
        u = res["unoise"]
        for k in ("train_loss", "mean_B"):
            assert abs(u["noise_metrics"][k] - float(m[k])) < LOSS_ATOL, (r, k)
        for k, g in grads.items():
            np.testing.assert_allclose(u["noise_grads"][k].numpy(), g.numpy(), err_msg=k,
                                       **GRAD)
        for k, v in stats.items():
            if "running" in k:
                np.testing.assert_allclose(u["noise_sd"][k].numpy(), v.numpy(), err_msg=k,
                                           **STATS)
    for k, v in ranks[0]["unoise"]["noise_sd"].items():
        assert torch.equal(v, ranks[1]["unoise"]["noise_sd"][k]), k


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------

def test_sharded_cls_step_matches_jax(world):
    import jax
    import jax.numpy as jnp

    from adlm_tpu.parallel.sharding import make_sharded_cls_step, shard_state
    from adlm_tpu.train import classification as jcls

    from adlm_tpu_torch.utils.jax_weights import cls_state_dict_from_jax

    from test_torch_train import _rel

    inp, get_ranks = world
    jcfg, model, params, bs = inp["cls_jax"]
    images, labels = jnp.asarray(inp["cls_images"]), jnp.asarray(inp["cls_labels"])
    st = jcls.init_classifier_state(model, jcfg, "joint", jax.random.PRNGKey(0), images,
                                    params=params, batch_stats=bs, steps_per_epoch=1)

    def lfn(p):
        (logits, min_d), _ = model.apply({"params": p, "batch_stats": st.batch_stats},
                                         images, train=True, mutable=["batch_stats"])
        return jcls.classification_loss(logits, min_d, labels, st.proto_class,
                                        p["last_layer"], jcfg)[0]

    grads = {k: v.numpy() for k, v in cls_state_dict_from_jax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(lfn))(st.params)), None,
        "resnet18").items()}
    mesh = _jax_mesh()
    new, m = make_sharded_cls_step(model, jcfg, "joint", mesh, steps_per_epoch=1)(
        shard_state(st, mesh), images, labels)
    sd = cls_state_dict_from_jax(jax.tree.map(np.asarray, new.params),
                                 jax.tree.map(np.asarray, new.batch_stats), "resnet18")
    ranks = get_ranks()
    for r, res in enumerate(ranks):
        c = res["cls"]
        for k in ("loss", "cross_entropy", "cluster", "separation", "avg_separation", "l1"):
            np.testing.assert_allclose(c["metrics"][k], float(m[k]), rtol=CLS_LOSS_RTOL,
                                       err_msg=f"rank {r}: {k}")
        assert c["metrics"]["n_correct"] == float(m["n_correct"])
        assert c["grads"] and set(c["grads"]) <= set(grads)
        for k, g in c["grads"].items():
            assert _rel(g.numpy(), grads[k]) <= CLS_GRAD_RTOL, k
        for k, v in sd.items():
            if "running" in k:
                np.testing.assert_allclose(c["sd"][k].numpy(), v.numpy(), err_msg=k, **STATS)
    for k, v in ranks[0]["cls"]["sd"].items():
        assert torch.equal(v, ranks[1]["cls"]["sd"][k]), k


# ---------------------------------------------------------------------------
# eval and push
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("upsampled", [False, True], ids=["grid", "upsampled"])
def test_sharded_eval_matches_jax(world, upsampled):
    from adlm_tpu.interpret.evaluate import SegEvaluator as JaxSegEvaluator
    from adlm_tpu.models.ppnet import default_proto_class as jax_pc

    inp, get_ranks = world
    jm, params, constants = inp["ev_jax"]
    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    ev = JaxSegEvaluator(jm, K, with_stats=True, stats_upsampled=upsampled,
                         mesh=_jax_mesh(), spatial=False)
    agree, purity = [], []
    for im, lb, n in eval_batches(inp["ev_images"], inp["ev_labels"], 2):
        o = ev.update(params, constants, jax_pc(P, K), im, lb)
        agree.append(np.asarray(o["agree_counts"])[:n])
        purity.append(np.asarray(o["topk_purity"])[:n])
    ranks = get_ranks()
    for r, res in enumerate(ranks):
        got = res["eval"][upsampled]
        assert got["total"] == ev.total, r              # the void mask is exact
        assert abs(got["correct"] - ev.correct) <= EVAL_TIE_BUDGET, r
        for key in ("intersection", "union"):
            assert np.abs(got[key] - getattr(ev, key)).sum() <= 2 * EVAL_TIE_BUDGET, (r, key)
        assert np.abs(got["agree"].numpy() - np.concatenate(agree)).sum() <= 2 * EVAL_TIE_BUDGET
        np.testing.assert_allclose(got["purity"].numpy(), np.concatenate(purity),
                                   atol=PURITY_ATOL)
    # every rank holds the same totals
    for key in ("intersection", "union", "agree", "purity"):
        a, b = (np.asarray(res["eval"][upsampled][key]) for res in ranks)
        np.testing.assert_array_equal(a, b)


def _assert_eval_close(ranks, key, upsampled, want):
    """Each rank's eval ``key`` against ``want`` (totals, agree and purity
    rows) within the eval budgets; every rank the same totals."""
    for r, res in enumerate(ranks):
        got = res[key][upsampled]
        assert got["total"] == want["total"], r              # the void mask is exact
        assert abs(got["correct"] - want["correct"]) <= EVAL_TIE_BUDGET, r
        for k in ("intersection", "union"):
            assert np.abs(got[k] - want[k]).sum() <= 2 * EVAL_TIE_BUDGET, (r, k)
        assert np.abs(got["agree"].numpy() - np.asarray(want["agree"])).sum() \
            <= 2 * EVAL_TIE_BUDGET
        np.testing.assert_allclose(got["purity"].numpy(), np.asarray(want["purity"]),
                                   atol=PURITY_ATOL)
    for k in ("intersection", "union", "agree", "purity"):
        a, b = (np.asarray(res[key][upsampled][k]) for res in ranks)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("upsampled", [False, True], ids=["grid", "upsampled"])
def test_spatial_eval_matches_jax(world, upsampled):
    import jax

    from adlm_tpu.core.mesh import MeshSpec as JaxMeshSpec, make_mesh as jax_make_mesh
    from adlm_tpu.interpret.evaluate import SegEvaluator as JaxSegEvaluator
    from adlm_tpu.models.ppnet import default_proto_class as jax_pc

    inp, get_ranks = world
    jm, params, constants = inp["ev_jax"]
    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    mesh = jax_make_mesh(JaxMeshSpec(data=1, model=WORLD), devices=jax.devices()[:WORLD])
    ev = JaxSegEvaluator(jm, K, with_stats=True, stats_upsampled=upsampled, mesh=mesh)
    agree, purity = [], []
    for im, lb, n in eval_batches(inp["sp_images"], inp["sp_labels"], 2):
        o = ev.update(params, constants, jax_pc(P, K), im, lb)
        agree.append(np.asarray(o["agree_counts"])[:n])
        purity.append(np.asarray(o["topk_purity"])[:n])
    want = {"intersection": ev.intersection, "union": ev.union, "correct": ev.correct,
            "total": ev.total, "agree": np.concatenate(agree),
            "purity": np.concatenate(purity)}
    _assert_eval_close(get_ranks(), "spatial", upsampled, want)


@pytest.mark.parametrize("upsampled", [False, True], ids=["grid", "upsampled"])
def test_spatial_eval_matches_one_process(world, upsampled):
    inp, get_ranks = world
    want = _spatial_eval(None, inp, device="cpu")[upsampled]
    _assert_eval_close(get_ranks(), "spatial", upsampled, want)


def _jax_msc_model(jm):
    import dataclasses

    from adlm_tpu.models.ppnet import PPNet as JaxPPNet

    return JaxPPNet(cfg=dataclasses.replace(jm.cfg, msc_scales=MSC_SCALES))


@pytest.mark.parametrize("upsampled", [False, True], ids=["grid", "upsampled"])
def test_msc_spatial_eval_matches_jax_and_one_process(world, upsampled):
    import jax

    from adlm_tpu.core.mesh import MeshSpec as JaxMeshSpec, make_mesh as jax_make_mesh
    from adlm_tpu.interpret.evaluate import SegEvaluator as JaxSegEvaluator
    from adlm_tpu.models.ppnet import default_proto_class as jax_pc

    inp, get_ranks = world
    jm, params, constants = inp["ev_jax"]
    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    mesh = jax_make_mesh(JaxMeshSpec(data=1, model=WORLD), devices=jax.devices()[:WORLD])
    ev = JaxSegEvaluator(_jax_msc_model(jm), K, with_stats=True, stats_upsampled=upsampled,
                         mesh=mesh)
    agree, purity = [], []
    for im, lb, n in eval_batches(inp["sp_images"], inp["sp_labels"], 2):
        o = ev.update(params, constants, jax_pc(P, K), im, lb)
        agree.append(np.asarray(o["agree_counts"])[:n])
        purity.append(np.asarray(o["topk_purity"])[:n])
    want = {"intersection": ev.intersection, "union": ev.union, "correct": ev.correct,
            "total": ev.total, "agree": np.concatenate(agree),
            "purity": np.concatenate(purity)}
    ranks = get_ranks()
    _assert_eval_close(ranks, "msc", upsampled, want)
    _assert_eval_close(ranks, "msc", upsampled,
                       _spatial_eval(None, inp, device="cpu", msc=True)[upsampled])


@pytest.fixture(scope="module")
def jax_tp(world):
    """The JAX package's tensor-parallel head on a (1, 2) device mesh:
    {upsampled: outputs}."""
    import jax
    import jax.numpy as jnp

    from adlm_tpu.core.mesh import MeshSpec as JaxMeshSpec, make_mesh as jax_make_mesh
    from adlm_tpu.models.ppnet import default_proto_class as jax_pc
    from adlm_tpu.parallel.sharding import make_sharded_inference_fn, prototype_parallel_params

    inp, _ = world
    jm, params, constants = inp["ev_jax"]
    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    mesh = jax_make_mesh(JaxMeshSpec(data=1, model=WORLD), devices=jax.devices()[:WORLD])
    tp_params = prototype_parallel_params(params, mesh)
    args = [jnp.asarray(inp[k]) for k in ("tp_images", "tp_labels", "tp_u", "tp_v")]
    out = {}
    for upsampled in (False, True):
        fn = make_sharded_inference_fn(jm, K, mesh, spatial=False, with_stats=True,
                                       prototype_parallel=True, stats_upsampled=upsampled)
        o = fn(tp_params, constants, jax_pc(P, K), *args)
        out[upsampled] = {k: np.asarray(o[k]) for k in TP_EXACT + ("topk_purity",)}
    return out


def _assert_tp_equal(got, want, what):
    for k in TP_EXACT:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=(what, k))
    np.testing.assert_allclose(np.asarray(got["topk_purity"]), np.asarray(want["topk_purity"]),
                               err_msg=what, **TP_PURITY)


@pytest.mark.parametrize("upsampled", [False, True], ids=["grid", "upsampled"])
def test_tensor_parallel_head_matches_jax_and_one_process(world, jax_tp, upsampled):
    inp, get_ranks = world
    one = _tp_eval(None, inp)[upsampled]
    ranks = get_ranks()
    for r, res in enumerate(ranks):
        got = res["tp"][upsampled]
        _assert_tp_equal(got, jax_tp[upsampled], f"rank {r} vs JAX")
        _assert_tp_equal(got, one, f"rank {r} vs one process")
    # the logits' SUM gives every model rank the same bits
    for k, v in ranks[0]["tp"][upsampled].items():
        assert torch.equal(v, ranks[1]["tp"][upsampled][k]), k


def test_spatial_with_the_tensor_parallel_head_equals_the_whole_bank(world):
    _, get_ranks = world
    for r, res in enumerate(get_ranks()):
        whole, tp = res["tp"]["spatial"]
        for k in whole:
            assert torch.equal(whole[k], tp[k]), (r, k)


def test_sharded_push_matches_jax_with_a_cross_rank_tie(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from adlm_tpu.interpret.push import make_push_batched_fn
    from adlm_tpu.models.ppnet import default_proto_class as jax_pc

    inp, get_ranks = world
    jm, params, constants = inp["ev_jax"]
    K, P = EVAL_MODEL["num_classes"], EVAL_MODEL["num_prototypes"]
    shard = NamedSharding(_jax_mesh(), PartitionSpec("data"))
    want = [np.asarray(a) for a in make_push_batched_fn(jm, K)(
        params, constants, jax_pc(P, K), jax.device_put(jnp.asarray(inp["push_images"]), shard),
        jax.device_put(jnp.asarray(inp["push_labels"]), shard))]
    ranks = get_ranks()
    got0 = [t.numpy() for t in ranks[0]["eval"]["push"]]
    got1 = [t.numpy() for t in ranks[1]["eval"]["push"]]
    seen = want[0] < 1e29
    np.testing.assert_allclose(got0[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got0[1:4], want[1:4]):
        np.testing.assert_array_equal(g[seen], w[seen])
    np.testing.assert_allclose(got0[4][seen], want[4][seen], rtol=1e-5, atol=1e-6)
    # frame 2 repeats frame 0: it never wins (the earlier global index does)
    assert not (got0[1] == 2).any() and (got0[1][seen] != 2).all()
    for a, b in zip(got0, got1):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ProtoSeg
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_protoseg(world):
    """JAX's sharded window from the same weights, plain and fused:
    {fused: (metrics, params before, params after)}."""
    import jax
    import jax.numpy as jnp

    from adlm_tpu.core import config as jcfg_mod
    from adlm_tpu.models.ppnet import default_proto_class as jax_pc
    from adlm_tpu.parallel.sharding import make_sharded_train_step, shard_state
    from adlm_tpu.train import protoseg as jtrain

    from test_torch_train import _named

    inp, _ = world
    jm, params, constants = inp["ps_jax"]
    mesh = _jax_mesh()
    out = {}
    for fused in (False, True):
        jcfg = _protoseg_cfg(jcfg_mod, fused)
        st = jtrain.init_protoseg_state(jm, jcfg, 1, 6, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 33, 33, 3)), params=params,
                                        constants=constants, proto_class=jax_pc(6, 3))
        before = _named(st.params)
        st = shard_state(st, mesh)
        st, m = make_sharded_train_step(jm, jcfg, 1, mesh, 6)(
            st, jnp.asarray(inp["ps_images"]), jnp.asarray(inp["ps_labels"]))
        out[fused] = ({k: float(v) for k, v in m.items()}, before, _named(st.params))
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_sharded_train_step_matches_jax(world, jax_protoseg, fused):
    from test_torch_train import _rel

    _, get_ranks = world
    want, before, after = jax_protoseg[fused]
    ranks = get_ranks()
    for r, res in enumerate(ranks):
        got = res["protoseg"][fused]["metrics"]
        for k in ("loss", "cross_entropy", "kld_loss", "l1", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"rank {r}: {k}")
        assert got["n_patches"] == want["n_patches"]
        assert abs(got["n_correct"] - want["n_correct"]) <= TIE_BUDGET
    params = ranks[0]["protoseg"][fused]["params"]
    for n, p in params.items():
        dt = p.numpy().astype(np.float64) - before[n]
        dj = after[n] - before[n]
        if not np.any(dj):
            assert not np.any(dt), f"{n} moved, JAX kept it"
        else:
            assert _rel(dt, dj) <= UPDATE_RTOL, f"{n}: {_rel(dt, dj)}"
    # every rank applied the same update
    for n, p in params.items():
        assert torch.equal(p, ranks[1]["protoseg"][fused]["params"][n]), n


def test_naive_average_of_rank_means_fails_the_tolerance(world, jax_protoseg):
    """The mean of each rank's own mean is not the global mean when the
    ranks hold different void shares: these labels show the fault."""
    _, get_ranks = world
    want = jax_protoseg[False][0]["loss"]
    ranks = get_ranks()
    naive = float(np.mean([res["protoseg"]["naive"] for res in ranks]))
    assert abs(naive - want) > METRIC_RTOL * abs(want), (naive, want)
