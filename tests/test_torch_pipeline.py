"""PyTorch port, the training run: ``adlm_tpu_torch.train.pipeline``
against ``adlm_tpu.train.pipeline``, and against itself.

The tiny experiment of tests/test_pipeline.py (6 prototypes of 3
classes, 8 channels, ``n_blocks=(1,1,1,1)``, 33² windows, iter_size 2:
two windows per phase) runs on a four-frame MDS-layout dataset of
40×48 frames per split, on the CPU.

* Against JAX: both packages start from the same random weights (JAX
  through its ``start_checkpoint``, the port through its own checkpoint
  written from those weights by ``state_dict_from_jax``) and run every
  stage with a validation after each window.  They must write the same
  checkpoint names, ``resume.json`` and CSV columns; the logged losses
  agree within ``LOSS_RTOL``; push keeps the same prototypes after
  dedup, with the same ``proto_class``; every ``push_last`` tensor
  agrees within ``PARAM_RTOL`` of its largest entry.  (Adam's first
  updates are ±lr for entries whose gradient sits at rounding noise, so
  the runs drift apart by a few learning rates: test_torch_train.py.)
* The from-scratch init (``bn_calibrate``, ``proto_init_data``): both
  packages start from the JAX initializers, with the warmup learning
  rates at 0, halt after one window, and hold the calibrated BN
  buffers, the folded pre-sigmoid convs and the data-drawn prototypes
  within ``INIT_RTOL`` of each other.  JAX's calibration batch is drawn
  from its unseeded ``SegmentationDataset.__getitem__``; the test
  patches it to the port's seeded draw (nothing in ``adlm_tpu`` changes).
* The port against itself: halts mid-warmup, at the warmup/joint
  boundary, mid-joint and mid-finetune, each resumed, end on exactly
  the unbroken run's state (every ``state_dict`` entry, ``proto_class``,
  ``step`` and Adam moment) and ``resume.json``; so does a resume that
  finds no stage checkpoint yet.  ``--pruned`` finetunes a pruned model,
  and the divergence guard saves nothing for a non-finite window, raises
  ``TrainingDiverged`` and makes the CLI exit 86.
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.core import config as jcfg_mod
from adlm_tpu.core.checkpoint import CheckpointStore as JaxStore
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.models.ppnet import default_proto_class as jax_proto_class
from adlm_tpu.train import pipeline as jpipe

from adlm_tpu_torch import cli
from adlm_tpu_torch.core import config as tcfg_mod
from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.train import pipeline as tpipe
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

from test_torch_models import random_variables

LOSS_RTOL = 1e-3
PARAM_RTOL = 2e-3
INIT_RTOL = 1e-4
# the CSV's columns whose values are compared (the rates are host timings)
COMPARED = ("loss", "cross_entropy", "kld_loss", "l1", "accuracy")

TINY_MODEL = dict(num_prototypes=6, num_classes=3, prototype_channels=8,
                  deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1), img_size=33)
TINY_DATA = dict(class_table="mds", window_size=(33, 33), scales=(0.9, 1.1),
                 dataloader_n_jobs=2)
TINY_TRAIN = dict(iter_size=2, warmup_steps=4, joint_steps=4, finetune_steps=4,
                  warmup_batch_size=2, joint_batch_size=2, loss_weight_kld=0.25)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny convs run op by op: one torch thread per test worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def experiments(name, **train_kw):
    """The tiny experiment registered under ``name`` in both packages."""
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        out.append(mod.register_experiment(mod.ExperimentConfig(
            name=name, model=mod.PPNetConfig(**TINY_MODEL),
            data=mod.DataConfig(**TINY_DATA),
            train=mod.TrainConfig(**dict(TINY_TRAIN, **train_kw)))))
    return out


def write_dataset(root, n=4, hw=(40, 48), block=1):
    """tests/test_pipeline.py's fake MDS-layout dataset; ``block`` > 1
    draws the labels in square blocks of that side."""
    rng = np.random.RandomState(0)
    ids = {}
    for split in ("train", "val"):
        img_dir = os.path.join(root, "img_with_margin_0", split)
        ann_dir = os.path.join(root, "annotations", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(ann_dir, exist_ok=True)
        ids[split] = [f"{split}{i}" for i in range(n)]
        for img_id in ids[split]:
            np.save(os.path.join(img_dir, img_id + ".npy"),
                    rng.randint(0, 255, size=(*hw, 3)).astype(np.uint8))
            cells = rng.randint(0, 3, size=(-(-hw[0] // block), -(-hw[1] // block)))
            labels = np.repeat(np.repeat(cells, block, 0), block, 1)[:hw[0], :hw[1]]
            np.save(os.path.join(ann_dir, img_id + ".npy"), labels.astype(np.uint8))
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump(ids, f)
    return root


def start_checkpoints(root, jcfg, seed):
    """The same random weights as a JAX ``warmup_last`` and a port
    ``warmup_last``: (JAX start_checkpoint, port start_checkpoint)."""
    params, consts = random_variables(JaxPPNet(cfg=jcfg.model), seed)
    pc = np.asarray(jax_proto_class(6, 3))
    JaxStore(os.path.join(root, "jax_start")).save(
        "warmup", "last", {"params": params, "constants": consts,
                           "proto_class": pc, "step": np.int32(0)})
    CheckpointStore(os.path.join(root, "port_start")).save(
        "warmup", "last", {"state_dict": state_dict_from_jax(params, consts),
                           "proto_class": torch.from_numpy(pc.copy()), "step": 0})
    return tuple(os.path.join(root, d, "checkpoints", "warmup_last")
                 for d in ("jax_start", "port_start"))


def read_csv(run_dir):
    with open(os.path.join(run_dir, "logs", "train_metrics.csv"), newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def read_resume(run_dir):
    with open(os.path.join(run_dir, "resume.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vs_jax"))
    data = write_dataset(os.path.join(root, "data"))
    jcfg, tcfg = experiments("tiny_port_vs_jax")
    jstart, tstart = start_checkpoints(root, jcfg, seed=41)
    kw = dict(data_path=data, val_every=1, push_batch_size=2)
    jrun, trun = os.path.join(root, "jax_run"), os.path.join(root, "port_run")
    jstate = jpipe.run_protoseg_training(jcfg, jrun, start_checkpoint=jstart, **kw)
    tstate = tpipe.run_protoseg_training(tcfg, trun, start_checkpoint=tstart,
                                         device="cpu", **kw)
    return dict(jrun=jrun, trun=trun, jstate=jstate, tstate=tstate)


def test_same_stage_files_and_resume_marker_as_jax(both_runs):
    jrun, trun = both_runs["jrun"], both_runs["trun"]
    names = sorted(os.listdir(os.path.join(trun, "checkpoints")))
    assert names == sorted(os.listdir(os.path.join(jrun, "checkpoints")))
    assert names == sorted(f"{s}_{k}" for s in ("warmup", "nopush", "push")
                           for k in ("best", "last"))
    for run in (jrun, trun):
        assert os.path.exists(os.path.join(run, "config.json"))
        assert os.path.exists(os.path.join(run, "prototypes", "unique_prototypes.json"))
    got, want = read_resume(trun), read_resume(jrun)
    same = ("stage", "windows_done", "n_windows", "completed")
    assert set(got) == set(want) and all(got[k] == want[k] for k in same), (got, want)
    assert got["stage"] == "push" and got["completed"]
    # the completed marker: the port writes the finetune's best val
    # accuracy and stale count, the JAX package the values it began with
    _, rows = read_csv(trun)
    val = [float(r["accuracy"]) for r in rows if r["phase"] == "push" and r["split"] == "val"]
    assert got["best_acc"] == pytest.approx(max(val)) and want["best_acc"] == -1.0
    with open(os.path.join(trun, "config.json")) as f, \
            open(os.path.join(jrun, "config.json")) as g:
        assert json.load(f) == json.load(g)


def test_same_csv_columns_and_losses_as_jax(both_runs):
    (th, trows), (jh, jrows) = read_csv(both_runs["trun"]), read_csv(both_runs["jrun"])
    assert th == jh
    assert [(r["step"], r["phase"], r["split"]) for r in trows] == \
        [(r["step"], r["phase"], r["split"]) for r in jrows]
    assert {r["phase"] for r in trows} == {"warmup", "nopush", "push"}
    for t, j in zip(trows, jrows):
        for k in COMPARED:
            if j[k] != "":
                np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=LOSS_RTOL,
                                           err_msg=f"{j['phase']} {j['split']} "
                                                   f"window {j['step']}: {k}")
    for row in trows:
        assert all(np.isfinite(float(row[k])) for k in COMPARED if row[k] != "")


def test_same_pushed_model_as_jax(both_runs):
    jstate, tstate = both_runs["jstate"], both_runs["tstate"]
    jpc = np.asarray(jstate.proto_class)
    assert tstate.proto_class.numpy().tolist() == jpc.tolist()
    assert tstate.model.cfg.num_prototypes == len(jpc)
    with open(os.path.join(both_runs["trun"], "prototypes", "unique_prototypes.json")) as f, \
            open(os.path.join(both_runs["jrun"], "prototypes", "unique_prototypes.json")) as g:
        assert json.load(f) == json.load(g)
    jp = JaxStore(both_runs["jrun"]).restore("push", "last")
    tp = CheckpointStore(both_runs["trun"]).restore("push", "last")
    want = state_dict_from_jax(jp["params"], jp["constants"])
    got = tp["state_dict"]
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.double()
        err = (got[k].double() - w).abs().max() / max(w.abs().max(), 1e-30)
        assert err <= PARAM_RTOL, f"push_last {k}: {err:.2e} of its largest entry"
    assert tp["step"] == int(jp["step"]) == 2
    assert tp["proto_class"].tolist() == np.asarray(jp["proto_class"]).tolist()


def test_from_scratch_init_matches_jax(tmp_path, monkeypatch):
    """bn-calibrate, the pre-sigmoid fold and proto-init in the pipeline,
    both packages from the JAX initializers, one warmup window at lr 0."""
    from adlm_tpu.data.dataset import SegmentationDataset as JaxDataset

    data = write_dataset(str(tmp_path / "data"))
    jcfg, tcfg = experiments(
        "tiny_port_init", bn_calibrate=True, proto_init_data=True,
        warm_optimizer_lr_add_on_layers=0.0, warm_optimizer_lr_prototype_vectors=0.0,
        warm_optimizer_weight_decay=0.0)
    seed = jcfg.train.random_seed
    jm = JaxPPNet(cfg=jcfg.model)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 33, 33, 3), jnp.float32))
    host = jax.tree.map(np.asarray, variables)
    init_sd = state_dict_from_jax(host["params"], host["constants"])

    getitem = JaxDataset.__getitem__
    monkeypatch.setattr(JaxDataset, "__getitem__", lambda self, i: (
        getitem(self, i) if self.is_eval else self.get_train_item(i, sample_seed=seed + i)))
    build = tpipe._build_model
    monkeypatch.setattr(tpipe, "_build_model", lambda cfg, sd=None, device=None: build(
        cfg, init_sd if sd is None else sd, device))

    kw = dict(data_path=data, val_every=100, halt_after_windows=1)
    jrun, trun = str(tmp_path / "jax"), str(tmp_path / "port")
    jpipe.run_protoseg_training(jcfg, jrun, **kw)
    tpipe.run_protoseg_training(tcfg, trun, device="cpu", **kw)
    jp = JaxStore(jrun).restore("warmup", "last")
    want = state_dict_from_jax(jp["params"], jp["constants"])
    got = CheckpointStore(trun).restore("warmup", "last")["state_dict"]
    changed = set()
    for k, w in want.items():
        w = w.double()
        err = (got[k].double() - w).abs().max() / max(w.abs().max(), 1e-30)
        assert err <= INIT_RTOL, f"{k}: {err:.2e} of its largest entry"
        if not torch.equal(got[k], init_sd[k]):
            changed.add(k)
    # the init set every BN's affine, the ASPP producers and the prototypes
    expect = {k for k in want if k.endswith((".bn.weight", ".bn.bias"))}
    expect |= {f"features.base.aspp.c{i}.weight" for i in range(4)}
    expect |= {"features.base.aspp.c0.bias", "prototype_vectors"}
    assert expect <= changed, sorted(expect - changed)
    with open(os.path.join(trun, "logs", "train.log")) as f:
        log = f.read()
    assert "bn-calibrate: done" in log and "proto-init:" in log


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

def _state_of(run_dir, stage="push"):
    return CheckpointStore(run_dir).restore(stage, "last")


def assert_same_state(a, b, what):
    """Two payloads equal bit for bit: weights, proto_class, step, Adam."""
    assert set(a["state_dict"]) == set(b["state_dict"]), what
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), f"{what}: {k}"
    assert torch.equal(a["proto_class"], b["proto_class"]), what
    assert a["step"] == b["step"] and a["phase"] == b["phase"], what
    assert set(a["opt"]) == set(b["opt"]), what
    for n in a["opt"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a["opt"][n][k], b["opt"][n][k]), f"{what}: {n}.{k}"


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("self"))
    data = write_dataset(os.path.join(root, "data"))
    _, tcfg = experiments("tiny_port_self")
    run = os.path.join(root, "unbroken")
    state = tpipe.run_protoseg_training(tcfg, run, data_path=data, val_every=1,
                                        push_batch_size=2, device="cpu",
                                        trace_dir=os.path.join(root, "traces"))
    return dict(root=root, data=data, cfg=tcfg, run=run, state=state)


def test_trace_dir_holds_one_trace_per_phase(unbroken):
    """``trace_dir`` profiles each phase's second window into
    ``<trace_dir>/<stage>/`` (the JAX package's contract)."""
    for stage in ("warmup", "nopush", "push"):
        d = os.path.join(unbroken["root"], "traces", stage)
        (name,) = os.listdir(d)
        assert name == f"{stage}_window.pt.trace.json"
        with open(os.path.join(d, name)) as f:
            assert json.load(f)["traceEvents"]


def test_validate_masks_the_wrapped_tail_like_jax(tmp_path):
    """Three val items in batches of 2: the second batch wraps to item 0
    and masks it; the metrics agree with the JAX package's ``_validate``
    within ``LOSS_RTOL``, and equal the port's over the three items one
    by one."""
    from adlm_tpu.data.dataset import SegmentationDataset as JaxDataset
    from adlm_tpu.train import protoseg as jtrain
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.models.ppnet import PPNet
    from adlm_tpu_torch.train import protoseg as ttrain

    data = write_dataset(str(tmp_path / "data"), n=3)
    jcfg, tcfg = experiments("tiny_port_validate")
    jm = JaxPPNet(cfg=jcfg.model)
    params, consts = random_variables(jm, 53)
    tm = PPNet(tcfg.model)
    tm.load_state_dict(state_dict_from_jax(params, consts), strict=True)
    jstate = jtrain.init_protoseg_state(jm, jcfg, 1, 4, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 33, 33, 3)), params=params,
                                        constants=consts)
    tstate = ttrain.init_protoseg_state(tm, tcfg, 1, 4, device="cpu")
    jval = JaxDataset(jcfg.data, "val", data_path=data, is_eval=True)
    tval = SegmentationDataset(tcfg.data, "val", data_path=data, is_eval=True)
    want = jpipe._validate(jtrain.make_eval_step(jm, jcfg), jstate, jval, 2)
    teval = ttrain.make_eval_step(tm, tcfg, device="cpu")
    got = tpipe._validate(teval, tstate, tval, 2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    one = tpipe._validate(teval, tstate, tval, 1)
    for k in got:
        assert got[k] == pytest.approx(one[k], rel=1e-6), k


# halt budget → (stage the halt leaves in resume.json, its windows_done,
# whether that stage is completed)
HALTS = {"mid_warmup": (1, "warmup", 1, False),
         "phase_boundary": (2, "warmup", 2, True),
         "mid_joint": (3, "nopush", 1, False),
         "mid_finetune": (5, "push", 1, False)}


@pytest.mark.parametrize("case", list(HALTS))
def test_halt_and_resume_is_bit_identical(unbroken, case):
    halt, stage, done, completed = HALTS[case]
    run = os.path.join(unbroken["root"], case)
    kw = dict(data_path=unbroken["data"], val_every=1, push_batch_size=2, device="cpu")
    tpipe.run_protoseg_training(unbroken["cfg"], run, halt_after_windows=halt, **kw)
    meta = read_resume(run)
    assert (meta["stage"], meta["windows_done"], meta["completed"]) == (stage, done, completed)
    store = CheckpointStore(run)
    assert not store.exists("push", "last") or case == "mid_finetune"
    if case == "phase_boundary":
        assert not store.exists("nopush", "last")   # the joint never started
    state = tpipe.run_protoseg_training(unbroken["cfg"], run, resume=True, **kw)
    assert_same_state(_state_of(run), _state_of(unbroken["run"]), case)
    assert read_resume(run) == read_resume(unbroken["run"])
    for a, b in zip(state.model.state_dict().values(),
                    unbroken["state"].model.state_dict().values()):
        assert torch.equal(a, b), case
    # resuming a complete run changes nothing and returns the final state
    again = tpipe.run_protoseg_training(unbroken["cfg"], run, resume=True, **kw)
    assert_same_state(_state_of(run), _state_of(unbroken["run"]), case)
    assert again.step == state.step


def test_resume_without_a_stage_checkpoint_starts_afresh(unbroken):
    run = os.path.join(unbroken["root"], "checkpointless")
    os.makedirs(run)
    with open(os.path.join(run, "resume.json"), "w") as f:
        json.dump({"stage": "warmup", "windows_done": 0, "n_windows": 2,
                   "completed": False, "best_acc": -1.0, "stale": 0}, f)
    tpipe.run_protoseg_training(unbroken["cfg"], run, data_path=unbroken["data"],
                                val_every=1, push_batch_size=2, resume=True, device="cpu")
    assert_same_state(_state_of(run), _state_of(unbroken["run"]), "checkpointless")
    with open(os.path.join(run, "logs", "train.log")) as f:
        assert "has no checkpoint yet" in f.read()
    with pytest.raises(SystemExit, match="nothing to resume"):
        tpipe.run_protoseg_training(unbroken["cfg"], os.path.join(unbroken["root"], "none"),
                                    data_path=unbroken["data"], resume=True, device="cpu")


def test_pruned_finetune_through_the_cli(unbroken, monkeypatch):
    results = os.path.join(unbroken["root"], "results")
    run = os.path.join(results, "pruned_run")
    shutil.copytree(unbroken["run"], run)
    monkeypatch.setenv("RESULTS_DIR", results)
    data = unbroken["data"]
    cli.main(["prune", run, "--data-path", data, "--k", "2", "--threshold", "1",
              "--device", "cpu"])
    info = np.load(os.path.join(run, "prune_info.npy"))
    pruned = CheckpointStore(run).restore("pruned", "last")
    n_push = _state_of(run)["state_dict"]["prototype_vectors"].shape[0]
    assert pruned["state_dict"]["prototype_vectors"].shape[0] == n_push - len(info)
    assert "opt" not in pruned
    cli.main(["train", unbroken["cfg"].name, "pruned_run", "--pruned", "--data-path",
              data, "--val-every", "1", "--device", "cpu"])
    meta = read_resume(run)
    assert meta["stage"] == "pruned" and meta["completed"]
    done = _state_of(run, "pruned")
    assert done["state_dict"]["prototype_vectors"].shape[0] == n_push - len(info)
    assert done["step"] == 2 and done["phase"] == 2
    for k, v in done["state_dict"].items():
        if k != "last_layer.weight":   # the finetune trains the last layer only
            assert torch.equal(v, pruned["state_dict"][k]), k
    assert not torch.equal(done["state_dict"]["last_layer.weight"],
                           pruned["state_dict"]["last_layer.weight"])


class _NanAfter:
    """A train step that runs the real one and reports a NaN loss from
    its ``n``-th call on."""

    def __init__(self, make, n):
        self.make, self.n, self.calls = make, n, 0

    def __call__(self, *args, **kwargs):
        step = self.make(*args, **kwargs)

        def nan_step(state, images, labels):
            state, m = step(state, images, labels)
            self.calls += 1
            if self.calls >= self.n:
                m = dict(m, loss=torch.tensor(float("nan")))
            return state, m
        return nan_step


def test_divergence_guard_saves_nothing_and_the_cli_exits_86(unbroken, monkeypatch):
    """A NaN at warmup window 2 (a validation window): the guard raises
    before the window's saves, so warmup_last keeps window 1's finite
    state and resume.json its count; the CLI exits 86."""
    from adlm_tpu_torch.train import protoseg

    results = os.path.join(unbroken["root"], "results_nan")
    monkeypatch.setenv("RESULTS_DIR", results)
    monkeypatch.setattr(protoseg, "make_train_step",
                        _NanAfter(protoseg.make_train_step, 2))
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", unbroken["cfg"].name, "nan_run", "--data-path",
                  unbroken["data"], "--val-every", "1", "--device", "cpu"])
    assert exc.value.code == cli.DIVERGED_EXIT == 86
    run = os.path.join(results, "nan_run")
    meta = read_resume(run)
    assert (meta["stage"], meta["windows_done"], meta["completed"]) == ("warmup", 1, False)
    store = CheckpointStore(run)
    last = store.restore("warmup", "last")
    assert last["step"] == 1
    assert all(bool(torch.isfinite(v).all()) for v in last["state_dict"].values())
    assert sorted(os.listdir(store.ckpt_dir)) == ["warmup_best", "warmup_last"]
    with open(os.path.join(run, "logs", "train.log")) as f:
        assert "NON-FINITE loss at validation window 1" in f.read()


def test_divergence_at_a_log_window_saves_nothing(tmp_path):
    """tests/test_pipeline.py's guard case on the port's ``_phase_loop``:
    finite metrics for 49 windows, NaN at the 50th (a log window)."""
    from adlm_tpu_torch.utils.logging import RunLogger

    calls = []

    def step_fn(state, images, labels):
        calls.append(1)
        bad = len(calls) >= 50
        m = {k: torch.tensor(1.0) for k in ("cross_entropy", "kld_loss", "l1")}
        m.update(loss=torch.tensor(float("nan") if bad else 1.0),
                 grad_norm=torch.tensor(float("inf") if bad else 1.0),
                 n_correct=torch.tensor(1.0), n_patches=torch.tensor(2.0))
        return state, m

    def loader():
        for _ in range(100):
            yield (np.zeros((2, 2, 8, 8, 3), np.float32), np.zeros((2, 2, 8, 8), np.uint8))

    run = str(tmp_path / "run")
    store, logger = CheckpointStore(run), RunLogger(run)
    with pytest.raises(tpipe.TrainingDiverged):
        tpipe._phase_loop(loader(), object(), step_fn, None, None, batch_size=2,
                          val_batches=None, n_windows=100, val_every=1000,
                          early_stopping_patience=None, stage="nopush",
                          store=store, logger=logger, device="cpu")
    assert len(calls) == 50
    assert not store.exists("nopush", "last") and not store.exists("nopush", "best")
    assert not os.path.exists(os.path.join(run, "resume.json"))
    _, rows = read_csv(run)
    assert [r["step"] for r in rows] == ["0", "49"]
    assert rows[-1]["loss"] == "nan"
