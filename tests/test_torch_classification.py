"""PyTorch port, the ProtoPNet classifier: ``adlm_tpu_torch.train.classification``,
``classification_pipeline`` and the ``cls-train`` / ``cls-prune`` /
``import-protopnet`` commands against ``adlm_tpu.train.classification``
and ``classification_pipeline``.

A tiny ResNet-18 classifier (``tests/test_classification.py``'s sizes:
32x32, P = 6, C = 16, K = 3) at batch 8.  The JAX state's variables go
into the port through ``cls_state_dict_from_jax``; inputs come from a
numpy seed; the JAX head runs its CPU (XLA) branch.  Tolerances (f32):

* the loss and its terms: rtol ``LOSS_RTOL`` = 1e-4; ``n_correct`` and
  each eval sample's correctness: equal;
* each trained tensor's gradient (``jax.value_and_grad`` of the JAX
  step's loss): ``GRAD_RTOL`` = 1e-4 relative L2 error (as
  ``test_torch_train.py``);
* each step's update Δ of every parameter entry: within
  ``UPDATE_ATOL`` = 1e-3 learning rates of JAX's, except where the JAX
  gradient is under ``NOISE_SHARE`` = 1e-3 of its tensor's largest:
  Adam's first update is ±lr·sign(g), so such an entry may step the
  other way, and is held to ``DRIFT_LRS`` = 2 learning rates per step.
  A tensor JAX leaves unchanged (the frozen groups) stays bit-unchanged;
  BN running statistics: rtol 1e-4, atol 1e-5;
* bf16 joint step: loss within ``BF16_LOSS`` = 5% of the f32 loss (the
  JAX package's own limit) and of the JAX bf16 step's;
* push: winners (image, row, column), RF boxes and the pruned set
  equal; min distances and pushed prototypes rtol 1e-5, atol 1e-5;
* the tiny training run (10 Adam updates, a push): the same stage
  files, CSV columns and accuracies; the final eval loss terms within
  ``RUN_RTOL`` = 1e-2.  The runs drift apart by the Adam steps above
  (lrs up to 3e-3): the pushed min distances already differ by 2e-3
  relative, with the same winners, and the final terms read 3.1e-3
  (cross-entropy), 2.7e-3 (cluster) and 1.2e-3 (separation).  The JAX
  run's final weights evaluated in the port agree with the JAX eval
  within ``LOSS_RTOL``.

The JAX programs are built once per module where the cases share them
(the initial variables, the gradients, each phase's step, the k-nearest
scan): tracing a flax ResNet under ``jax.grad`` costs seconds of the
file's time, the XLA compile about as much again.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.core.config import PPNetConfig as JaxPPNetConfig
from adlm_tpu.models.backbones import build_classification_backbone as jax_stem
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.train import classification as jcls
from adlm_tpu.utils.receptive_field import proto_layer_rf_info as jax_rf_info

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.models.backbones import build_classification_backbone
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.train import classification as tcls
from adlm_tpu_torch.utils.jax_weights import cls_state_dict_from_jax
from adlm_tpu_torch.utils.receptive_field import proto_layer_rf_info

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
UPDATE_ATOL = 1e-3
NOISE_SHARE = 1e-3
DRIFT_LRS = 2.0
RUN_RTOL = 1e-2
EPOCH_RTOL = 1e-3
STATS = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS = 0.05
CLOSE = dict(rtol=1e-5, atol=1e-5)
B, HW, PUSH_HW = 8, 32, 64
STEP_LR = dict(joint_lr_step_size=1)   # 1 update per epoch: the lr drops at update 2
METRICS = ("loss", "cross_entropy", "cluster", "separation", "avg_separation", "l1",
           "n_correct")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _model_cfg(cls):
    return cls(base_architecture="resnet18", img_size=HW, num_prototypes=6,
               prototype_channels=16, num_classes=3, add_on_layers_type="regular",
               patch_classification=False)


def configs(**kw):
    return (jcls.ClassificationConfig(model=_model_cfg(JaxPPNetConfig), **kw),
            tcls.ClassificationConfig(model=_model_cfg(PPNetConfig), **kw))


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its initial variables (``model.init`` under one
    ``jax.jit``: an eager flax init of the ResNet compiles op by op, three
    times as long), and seeded batches."""
    jcfg, _ = configs()
    model = JaxPPNet(cfg=jcfg.model)
    rng = np.random.RandomState(1)
    images = rng.randn(B, HW, HW, 3).astype(np.float32)
    labels = np.arange(B) % 3
    variables = jax.jit(lambda key, x: model.init(key, x, train=True))(
        jax.random.PRNGKey(0), images)
    return dict(model=model, params=jax.tree.map(np.asarray, variables["params"]),
                batch_stats=jax.tree.map(np.asarray, variables["batch_stats"]),
                images=images, labels=labels, rng=rng)


@pytest.fixture(scope="module")
def setup_grads(setup):
    """The JAX step's gradients at ``setup``'s variables: the same for
    every phase and learning rate, so computed once."""
    jcfg, _ = configs()
    return jax_grads(setup, jcfg, jax_state(setup, jcfg, "warm"), setup["images"],
                     setup["labels"])


@pytest.fixture(scope="module")
def jax_steps(setup):
    """``run(phase, n)``: the first ``n`` JAX steps of ``phase`` from
    ``setup``'s variables at a 1-epoch StepLR (``STEP_LR``), as
    [(state, metrics)]; each phase's step is compiled once and its
    states kept for the next caller."""
    jcfg, _ = configs(**STEP_LR)
    runs = {}

    def run(phase, n=1):
        if phase not in runs:
            runs[phase] = (jcls.make_cls_train_step(setup["model"], jcfg, phase,
                                                    steps_per_epoch=1),
                           [(jax_state(setup, jcfg, phase), None)])
        step, seq = runs[phase]
        while len(seq) <= n:
            seq.append(step(seq[-1][0], jnp.asarray(setup["images"]),
                            jnp.asarray(setup["labels"])))
        return seq[1:n + 1]

    return run


def port_of(setup, tcfg, params=None, batch_stats=None):
    model = PPNet(tcfg.model)
    model.load_state_dict(cls_state_dict_from_jax(
        setup["params"] if params is None else params,
        setup["batch_stats"] if batch_stats is None else batch_stats, "resnet18"))
    return model


def jax_state(setup, jcfg, phase, steps_per_epoch=1):
    return jcls.init_classifier_state(
        setup["model"], jcfg, phase, jax.random.PRNGKey(0), jnp.asarray(setup["images"]),
        params=setup["params"], batch_stats=setup["batch_stats"],
        steps_per_epoch=steps_per_epoch)


def assert_metrics(got, want, keys=METRICS):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)


def _sd(jstate):
    return {k: v.numpy() for k, v in cls_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats), "resnet18").items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_grads(setup, jcfg, jstate, images, labels):
    """The JAX step's gradients (its ``lfn``, f32), in the port's names."""
    def lfn(params):
        (logits, min_d), _ = setup["model"].apply(
            {"params": params, "batch_stats": jstate.batch_stats}, images, train=True,
            mutable=["batch_stats"])
        return jcls.classification_loss(logits, min_d, labels, jstate.proto_class,
                                        params["last_layer"], jcfg)[0]

    g = jax.jit(jax.grad(lfn))(jstate.params)
    return {k: v.numpy() for k, v in cls_state_dict_from_jax(
        jax.tree.map(np.asarray, g), None, "resnet18").items()}


def assert_updates(model, state, jstate, prev_t, prev_j, grads_j, n_steps):
    """The port's step from ``prev_t`` against JAX's from ``prev_j``
    (module docstring); ``grads_j``: the JAX step's gradients."""
    cur_j = _sd(jstate)
    lr = {n: g["base_lr"] for g in state.optimizer.param_groups for n in
          [k for k, p in model.named_parameters() if any(p is q for q in g["params"])]}
    params = dict(model.named_parameters())
    for k, v in model.state_dict().items():
        cur = v.numpy()
        if "running" in k:
            np.testing.assert_allclose(cur, cur_j[k], **STATS, err_msg=k)
            continue
        dj, dt = cur_j[k] - prev_j[k], cur - prev_t[k]
        if k not in lr:
            assert not np.any(dj) and not np.any(dt), f"{k} is frozen"
            continue
        g = grads_j[k]
        assert _rel(params[k].grad.numpy(), g) <= GRAD_RTOL, f"{k} grad {_rel(params[k].grad.numpy(), g)}"
        noisy = np.abs(g) <= NOISE_SHARE * np.abs(g).max()
        err = np.abs(dt - dj)
        assert err[~noisy].max(initial=0.0) <= UPDATE_ATOL * lr[k], f"{k} update"
        drift = np.abs(cur - cur_j[k]).max()
        assert drift <= DRIFT_LRS * lr[k] * n_steps, f"{k} drift {drift}"


@pytest.mark.parametrize("class_specific", [True, False])
def test_classification_loss(class_specific):
    rng = np.random.RandomState(0)
    logits = rng.randn(5, 4).astype(np.float32)
    min_d = (rng.rand(5, 8) * 16).astype(np.float32)
    labels = rng.randint(0, 4, 5)
    pc = np.arange(8) // 2
    w = rng.randn(8, 4).astype(np.float32)
    jcfg, tcfg = configs()
    jl, jm = jcls.classification_loss(jnp.asarray(logits), jnp.asarray(min_d),
                                      jnp.asarray(labels), jnp.asarray(pc), jnp.asarray(w),
                                      jcfg, class_specific)
    tl, tm = tcls.classification_loss(torch.from_numpy(logits), torch.from_numpy(min_d),
                                      torch.from_numpy(labels), torch.from_numpy(pc),
                                      torch.from_numpy(w), tcfg, class_specific)
    assert_metrics(dict(tm, loss=tl), dict(jm, loss=jl))


@pytest.mark.parametrize("phase", ["warm", "joint", "last"])
def test_one_step_per_phase(setup, setup_grads, jax_steps, phase):
    """One step of ``phase`` (at ``STEP_LR``, whose first update runs at
    the base lr) against JAX's."""
    _, tcfg = configs(**STEP_LR)
    [(jstate, jm)] = jax_steps(phase)
    model = port_of(setup, tcfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    prev = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    state = tcls.init_classifier_state(model, tcfg, phase, device="cpu")
    step = tcls.make_cls_train_step(model, tcfg, phase, device="cpu")
    state, m = step(state, setup["images"], setup["labels"])
    assert_metrics(m, jm)
    assert_updates(model, state, jstate, prev, prev, setup_grads, 1)
    trained = tcls.cls_phase_groups(tcfg, phase)
    labels = tcls.label_cls_params(model)
    for n, p in model.named_parameters():
        if labels[n] in trained:
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n       # frozen: bit-unchanged
    assert state.step == 1 and model.training


def test_joint_steps_across_a_step_lr_boundary(setup, setup_grads, jax_steps):
    """StepLR(1 epoch, 0.1) at 1 update per epoch: the second update
    runs at a tenth of the lr, in both packages.  The first step is held
    as ``test_one_step_per_phase``; the second starts from states that
    differ by the first's sign flips, so it is held by its metrics, its
    lrs and the drift bound."""
    _, tcfg = configs(**STEP_LR)
    model = port_of(setup, tcfg)
    state = tcls.init_classifier_state(model, tcfg, "joint", steps_per_epoch=1, device="cpu")
    step = tcls.make_cls_train_step(model, tcfg, "joint", device="cpu")
    prev = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for i, (jstate, jm) in enumerate(jax_steps("joint", 2)):
        state, m = step(state, setup["images"], setup["labels"])
        assert_metrics(m, jm)
        if i == 0:
            assert_updates(model, state, jstate, prev, prev, setup_grads, 1)
            assert all(g["lr"] == g["base_lr"] for g in state.optimizer.param_groups)
    assert [g["lr"] for g in state.optimizer.param_groups] == pytest.approx(
        [0.1 * g["base_lr"] for g in state.optimizer.param_groups])
    cur_j = _sd(jstate)
    for g in state.optimizer.param_groups:
        for p in g["params"]:
            name = next(n for n, q in model.named_parameters() if q is p)
            drift = np.abs(p.detach().numpy() - cur_j[name]).max()
            assert drift <= DRIFT_LRS * 1.1 * g["base_lr"], name


def test_bf16_joint_step_tracks_f32(setup):
    jcfg, tcfg = configs(compute_dtype="bfloat16")
    _, jm = jcls.make_cls_train_step(setup["model"], jcfg, "joint")(
        jax_state(setup, jcfg, "joint"), jnp.asarray(setup["images"]),
        jnp.asarray(setup["labels"]))
    losses = {}
    for name, cfg in (("bf16", tcfg), ("f32", configs()[1])):
        model = port_of(setup, cfg)
        state = tcls.init_classifier_state(model, cfg, "joint", device="cpu")
        step = tcls.make_cls_train_step(model, cfg, "joint", device="cpu")
        for _ in range(2):   # the second step reads the first's state
            state, m = step(state, setup["images"], setup["labels"])
            losses.setdefault(name, float(m["loss"]))
        assert np.isfinite(float(m["loss"]))
        assert all(v.dtype == torch.float32 for v in model.state_dict().values()
                   if v.is_floating_point())
        assert all(t.dtype == torch.float32 for s in state.optimizer.state.values()
                   for k, t in s.items() if k != "step")
    for other in (losses["f32"], float(jm["loss"])):
        assert abs(losses["bf16"] - other) < BF16_LOSS * max(1.0, abs(other))


def test_eval_step(setup):
    jcfg, tcfg = configs()
    jm = jcls.make_cls_eval_step(setup["model"], jcfg)(
        jax_state(setup, jcfg, "warm"), jnp.asarray(setup["images"]),
        jnp.asarray(setup["labels"]))
    model = port_of(setup, tcfg)
    state = tcls.init_classifier_state(model, tcfg, None, device="cpu")
    m = tcls.make_cls_eval_step(model, tcfg, device="cpu")(state, setup["images"],
                                                           setup["labels"])
    assert_metrics(m, dict(jm, loss=0.0), keys=METRICS[1:])
    np.testing.assert_array_equal(m["correct"].numpy(), np.asarray(jm["correct"]))
    assert not model.training


@pytest.fixture(scope="module")
def push_batches(setup):
    """Seeded 64x64 images (a 2x2 feature grid), two full batches and a
    tail batch of 3 real images wrapped with copies of the first: a
    wrapped copy ties its original and must not win."""
    rng = np.random.RandomState(7)
    images = rng.randn(19, PUSH_HW, PUSH_HW, 3).astype(np.float32)
    labels = rng.randint(0, 3, 19)
    order = list(range(19)) + [0, 1, 2, 3, 4]
    return [(images[order[i:i + 8]], labels[order[i:i + 8]], min(19 - i, 8))
            for i in range(0, 24, 8)]


def test_push_winners_distances_and_boxes(setup, push_batches):
    jcfg, tcfg = configs()
    stem = build_classification_backbone("resnet18")
    rf = proto_layer_rf_info(PUSH_HW, *stem.conv_info())
    assert rf == jax_rf_info(PUSH_HW, *jax_stem("resnet18").conv_info())
    jparams, jinfo = jcls.push_classification_prototypes(
        setup["model"], jax_state(setup, jcfg, "warm"), push_batches, rf_info=rf)
    model = port_of(setup, tcfg)
    state = tcls.init_classifier_state(model, tcfg, None, device="cpu")
    protos, info = tcls.push_classification_prototypes(state, push_batches, rf_info=rf,
                                                       device="cpu")
    np.testing.assert_array_equal(info["rf_boxes"], jinfo["rf_boxes"])
    assert info["rf_boxes"][:, 0].max() < 19
    np.testing.assert_allclose(info["min_distances"], jinfo["min_distances"], **CLOSE)
    np.testing.assert_allclose(protos.numpy(), np.asarray(jparams["prototype_vectors"]),
                               **CLOSE)
    # the cells without the RF calculator, and the model left as it was
    _, cells = tcls.push_classification_prototypes(state, push_batches, device="cpu")
    _, jcells = jcls.push_classification_prototypes(
        setup["model"], jax_state(setup, jcfg, "warm"), push_batches)
    np.testing.assert_array_equal(cells["rf_boxes"], jcells["rf_boxes"])
    assert not torch.equal(model.prototypes(), protos)
    tcls.set_prototypes(model, protos)
    assert torch.equal(model.prototypes(), protos)


@pytest.fixture(scope="module")
def jax_k_nearest(setup, push_batches):
    jcfg, _ = configs()
    return jcls.find_k_nearest_patches_classification(
        setup["model"], jax_state(setup, jcfg, "warm"), push_batches, k=4)


@pytest.mark.parametrize("threshold", [1, 2])
def test_k_nearest_scan_and_prune(setup, push_batches, jax_k_nearest, threshold):
    jcfg, tcfg = configs()
    jstate = jax_state(setup, jcfg, "warm")
    jparams, jpc, jinfo = jcls.prune_classification_prototypes(
        setup["model"], jstate, push_batches, k=4, prune_threshold=threshold,
        log=lambda *_: None)
    model = port_of(setup, tcfg)
    state = tcls.init_classifier_state(model, tcfg, None, device="cpu")
    got = tcls.find_k_nearest_patches_classification(state, push_batches, k=4, device="cpu")
    np.testing.assert_array_equal(got, jax_k_nearest)
    sd, pc, pinfo = tcls.prune_classification_prototypes(
        state, push_batches, k=4, prune_threshold=threshold, log=lambda *_: None,
        device="cpu")
    np.testing.assert_array_equal(pinfo, jinfo)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jpc))
    assert 0 < pc.shape[0] < 6 or threshold == 1
    pruned = tcls.build_classifier(tcls.with_prototypes(tcfg, pc.shape[0]), "cpu",
                                   state_dict=sd)
    np.testing.assert_array_equal(pruned.prototypes().detach().numpy(),
                                  np.asarray(jparams["prototype_vectors"]))
    np.testing.assert_array_equal(pruned.last_layer.weight.t().detach().numpy(),
                                  np.asarray(jparams["last_layer"]))


# the tiny run's schedule: 3 epochs (1 warm), a push at epoch 2 and 2
# last-layer iterations; RUN_PHASES is the phase of each epoch it steps
RUN = dict(num_epochs=3, last_layer_iterations=2, push_every=1)
RUN_PHASES = ("warm", "joint", "joint", "last", "last")


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):
    """The JAX package's tiny run from ``setup``'s variables (in place of
    its own seeded init), with the state before and after each epoch it
    steps (``epochs``)."""
    from adlm_tpu.train import classification_pipeline as jpipe

    jcfg, _ = configs(num_warm_epochs=1, push_start=2)
    rng = np.random.RandomState(9)
    images = rng.randn(2 * B, HW, HW, 3).astype(np.float32)
    labels = np.arange(2 * B) % 3

    def batches():
        for i in range(0, 2 * B, B):
            yield images[i:i + B], labels[i:i + B]

    def jax_init(model, cfg, phase, rng, sample, params=None, batch_stats=None, **kw):
        if params is None:   # the run's first state
            params, batch_stats = setup["params"], setup["batch_stats"]
        return jcls.init_classifier_state(model, cfg, phase, rng, sample, params=params,
                                          batch_stats=batch_stats, **kw)

    epochs = []
    epoch = jpipe._epoch

    def recorded(step_fn, state, batches):
        out, acc = epoch(step_fn, state, batches)
        epochs.append((state, out))
        return out, acc

    run_dir = tmp_path_factory.mktemp("cls_run") / "jax"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "init_classifier_state", jax_init)
        mp.setattr(jpipe, "_epoch", recorded)
        jstate = jpipe.run_classification_training(jcfg, str(run_dir), batches, batches,
                                                   **RUN)
    assert len(epochs) == len(RUN_PHASES)
    return dict(jcfg=jcfg, jstate=jstate, dir=run_dir, epochs=epochs, images=images,
                labels=labels, batches=batches,
                eval=jcls.make_cls_eval_step(JaxPPNet(cfg=jcfg.model), jcfg))


def test_tiny_training_run_against_the_jax_run(setup, jax_run, tmp_path, monkeypatch):
    """``run_classification_training`` of both packages from ``setup``'s
    variables (in place of each run's own seeded init): 3 epochs (1
    warm), a push at epoch 2 and 2 last-layer iterations."""
    from adlm_tpu.core.checkpoint import CheckpointStore as JaxStore

    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.train import classification_pipeline as tpipe

    _, tcfg = configs(num_warm_epochs=1, push_start=2)
    jcfg, jstate, images, batches = (jax_run[k] for k in ("jcfg", "jstate", "images",
                                                          "batches"))
    labels = jax_run["labels"]
    dirs = {"jax": jax_run["dir"], "port": tmp_path / "port"}
    sd = cls_state_dict_from_jax(setup["params"], setup["batch_stats"], "resnet18")
    monkeypatch.setattr(tpipe, "build_classifier",
                        lambda cfg, dev, seed: tcls.build_classifier(cfg, dev, state_dict=sd))
    state = tpipe.run_classification_training(tcfg, str(dirs["port"]), batches,
                                              batches, device="cpu", **RUN)
    for sub in ("jax", "port"):
        assert (dirs[sub] / "cls_config.json").exists()
    jstore, store = JaxStore(str(dirs["jax"])), CheckpointStore(str(dirs["port"]))
    for stage in ("nopush", "push", "pruned"):
        for kind in ("last", "best"):
            assert store.exists(stage, kind) == jstore.exists(stage, kind), (stage, kind)
    assert store.exists("push", "best") and store.exists("nopush", "last")

    def rows(sub):
        with open(dirs[sub] / "logs" / "classification_metrics.csv") as f:
            return list(csv.DictReader(f))

    got, want = rows("port"), rows("jax")
    assert list(got[0]) == list(want[0]) and len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert (g["step"], g["phase"]) == (w["step"], w["phase"])
        for k in ("accuracy", "train_accuracy"):
            assert g[k] == w[k], (g, w)
    log = (dirs["port"] / "logs" / "classification.log").read_text()
    assert "epoch 2: prototype push" in log
    # the final states' eval loss
    jm = jax_run["eval"](jstate, jnp.asarray(images[:B]), jnp.asarray(labels[:B]))
    m = tcls.make_cls_eval_step(state.model, tcfg, device="cpu")(state, images[:B],
                                                                 labels[:B])
    same = tcls.build_classifier(tcfg, "cpu", state_dict={
        k: torch.from_numpy(v) for k, v in _sd(jstate).items()})
    m_same = tcls.make_cls_eval_step(same, tcfg, device="cpu")(
        tcls.init_classifier_state(same, tcfg, None, device="cpu"), images[:B], labels[:B])
    assert_metrics(m_same, dict(jm, loss=0.0), keys=METRICS[1:])
    for k in ("cross_entropy", "cluster", "separation"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RUN_RTOL, err_msg=k)
    assert tpipe.load_cls_config(str(dirs["port"])) == tcfg
    with open(dirs["jax"] / "cls_config.json") as f, \
            open(dirs["port"] / "cls_config.json") as g:
        assert f.read() == g.read()



def _adam_node(tree):
    """The ``ScaleByAdamState`` inside one group's optax state, or None
    (a frozen group's ``set_to_zero``)."""
    import optax

    if isinstance(tree, optax.ScaleByAdamState):
        return tree
    if isinstance(tree, tuple):
        for child in tree:
            node = _adam_node(child)
            if node is not None:
                return node
    return None


def _port_state_from_jax(jstate, tcfg, phase: str, steps_per_epoch: int):
    """A port state of ``phase`` on the CPU holding the JAX state: its
    weights, BN statistics, prototype classes, update count and each
    trained group's Adam moments (masked-out leaves of optax's moment
    trees are zeros, and no group of the port's holds them)."""
    import optax

    model = tcls.build_classifier(tcfg, "cpu", state_dict={
        k: torch.from_numpy(v) for k, v in _sd(jstate).items()})
    state = tcls.init_classifier_state(
        model, tcfg, phase, steps_per_epoch,
        proto_class=torch.from_numpy(np.asarray(jstate.proto_class)), device="cpu")
    state.step = int(jstate.step)
    params = jax.tree.map(np.asarray, jstate.params)
    labels = tcls.label_cls_params(model)
    named = dict(model.named_parameters())
    loaded = set()
    for label, inner in jstate.opt_state.inner_states.items():
        node = _adam_node(inner)
        if node is None:
            continue
        mu, nu = (cls_state_dict_from_jax(jax.tree.map(
            lambda p, m: np.zeros(np.shape(p), np.float32) if isinstance(m, optax.MaskedNode)
            else np.asarray(m), params, tree), None, "resnet18") for tree in (node.mu, node.nu))
        for name in (n for n, lab in labels.items() if lab == label):
            p = named[name]
            state.optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(node.count)), dtype=torch.float32),
                "exp_avg": torch.empty_like(p).copy_(mu[name].reshape(p.shape)),
                "exp_avg_sq": torch.empty_like(p).copy_(nu[name].reshape(p.shape))}
            loaded.add(name)
    assert loaded == {n for n, lab in labels.items() if lab in tcls.cls_phase_groups(tcfg, phase)}
    return state


@pytest.mark.parametrize("epoch", range(len(RUN_PHASES)))
def test_each_epoch_of_the_tiny_run_from_the_jax_runs_state(jax_run, epoch):
    """The tiny run's drift (``RUN_RTOL``) is accumulation: the port
    started from the JAX run's state where one of its epochs starts
    (after the push for the last-layer epochs) ends that epoch within
    ``EPOCH_RTOL`` of the JAX epoch's eval terms."""
    jcfg, (_, tcfg) = jax_run["jcfg"], configs(num_warm_epochs=1, push_start=2)
    phase = RUN_PHASES[epoch]
    start, end = jax_run["epochs"][epoch]
    state = _port_state_from_jax(start, tcfg, phase, steps_per_epoch=2)
    step = tcls.make_cls_train_step(state.model, tcfg, phase, device="cpu")
    for images, labels in jax_run["batches"]():
        state, _ = step(state, images, labels)
    assert state.step == int(end.step)
    images, labels = jax_run["images"][:B], jax_run["labels"][:B]
    jm = jax_run["eval"](end, jnp.asarray(images), jnp.asarray(labels))
    m = tcls.make_cls_eval_step(state.model, tcfg, device="cpu")(state, images, labels)
    for k in ("cross_entropy", "cluster", "separation"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=EPOCH_RTOL, err_msg=k)

def _write_folder(root, rng, n_per_class):
    from adlm_tpu_torch.interpret.visualize import write_png

    for split, n in n_per_class.items():
        for c in ("ant", "bee", "cat"):
            os.makedirs(root / split / c)
            for i in range(n):
                write_png(str(root / split / c / f"{i}.png"),
                          rng.randint(0, 256, (40, 36, 3)).astype(np.uint8))


def test_cli_train_prune_and_import(tmp_path, monkeypatch):
    from adlm_tpu_torch import cli
    from adlm_tpu_torch.core.checkpoint import CheckpointStore
    from adlm_tpu_torch.data.image_folder import ImageFolderDataset
    from adlm_tpu_torch.train.classification_pipeline import evaluate, load_cls_config

    _write_folder(tmp_path, np.random.RandomState(0), {"train": 2, "test": 1})
    monkeypatch.setenv("RESULTS_DIR", str(tmp_path / "runs"))
    dirs = ["--train-dir", str(tmp_path / "train"), "--test-dir", str(tmp_path / "test")]
    cli.main(["cls-train", "clsrun", "--arch", "resnet18", "--img-size", str(HW),
              "--prototypes", "6", "--proto-channels", "8", "--batch-size", "4",
              "--test-batch-size", "2", "--push-batch-size", "4", "--epochs", "3",
              "--warm-epochs", "1", "--push-start", "2", "--push-every", "2",
              "--last-layer-iterations", "2", "--device", "cpu"] + dirs)
    run_dir = tmp_path / "runs" / "clsrun"
    store = CheckpointStore(str(run_dir))
    assert store.exists("nopush", "last")
    log = (run_dir / "logs" / "classification.log").read_text()
    assert "epoch 2: prototype push" in log
    cfg = load_cls_config(str(run_dir))
    assert (cfg.model.num_prototypes, cfg.model.num_classes, cfg.num_warm_epochs) == (6, 3, 1)

    cli.main(["cls-prune", str(run_dir), "--batch-size", "4", "--k", "3", "--threshold", "1",
              "--last-layer-iterations", "1", "--device", "cpu"] + dirs)
    pruned = store.restore("pruned", "last")
    info = np.load(run_dir / "cls_prune_info.npy")
    assert info.shape[1] == 2
    assert pruned["proto_class"].shape[0] == 6 - info.shape[0]

    # a reference-format state_dict of the trained model, imported back
    push = store.restore("nopush", "last")
    torch.save({"state_dict": push["state_dict"]}, tmp_path / "ref.pth")
    cli.main(["import-protopnet", "imported", str(tmp_path / "ref.pth"), "--arch", "resnet18",
              "--img-size", str(HW), "--device", "cpu"])
    imp = CheckpointStore(str(tmp_path / "runs" / "imported"))
    got = imp.restore("push", "best")
    for k, v in push["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    assert torch.equal(got["proto_class"], torch.arange(6) // 2)
    test = ImageFolderDataset(str(tmp_path / "test"), HW)
    accs = []
    for payload in (push, got):
        model = tcls.build_classifier(cfg, "cpu", state_dict=payload["state_dict"])
        state = tcls.init_classifier_state(model, cfg, None, device="cpu")
        accs.append(evaluate(tcls.make_cls_eval_step(model, cfg, device="cpu"), state,
                             test.batches(2, with_count=True)))
    assert accs[0] == accs[1]
    # a ragged (pruned) checkpoint needs its classes
    torch.save(pruned["state_dict"], tmp_path / "pruned.pth")
    if pruned["proto_class"].shape[0] % 3:
        with pytest.raises(SystemExit, match="proto-class"):
            cli.main(["import-protopnet", "imp2", str(tmp_path / "pruned.pth"),
                      "--arch", "resnet18", "--img-size", str(HW), "--device", "cpu"])
    # a truncated checkpoint is refused
    sd = dict(push["state_dict"])
    del sd["features.layer4.1.bn2.running_var"]
    torch.save(sd, tmp_path / "cut.pth")
    with pytest.raises(SystemExit, match="uninitialized"):
        cli.main(["import-protopnet", "imp3", str(tmp_path / "cut.pth"), "--arch", "resnet18",
                  "--img-size", str(HW), "--device", "cpu"])
    # --mesh-data is ported (its 2-rank run: tests/test_torch_mesh.py); the
    # batch must divide over it, as in the JAX CLI
    with pytest.raises(SystemExit, match="divisible by --mesh-data"):
        cli.main(["cls-train", "x", "--mesh-data", "3", "--batch-size", "4"] + dirs)
    assert dataclasses.asdict(cfg)["model"]["base_architecture"] == "resnet18"
