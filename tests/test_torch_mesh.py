"""PyTorch port, the mesh and its entry points: ``adlm_tpu_torch.core.mesh``
against ``adlm_tpu.core.mesh``, the rank slices of every loader, and the
``--mesh-data`` / ``--mesh-model`` / ``--distributed`` flags of the CLI.

* ``MeshSpec.resolve`` (values and errors) and the rank → (data, model)
  layout equal the JAX package's device layout on the cases
  ``(data, model, n)`` = (-1, 1, 8), (2, 2, 4), (4, 2, 8), (3, 1, 4) and
  (-1, 3, 8).
* Each loader's rank slices, concatenated in rank order, equal the
  single-process stream bit for bit: ``superbatch_iterator`` in its
  three modes, ``SegmentationDataset.eval_batches`` (the padded tail),
  ``ImageFolderDataset.batches`` (the wrapped tail) and U-Noise's
  ``batches`` under ``drop_last``.
* The CLI on the CPU, each multi-rank command in a subprocess under a
  time limit: ``train smoke --mesh-data 2`` and the same under
  ``torchrun --nproc-per-node 2 ... --distributed`` end on the weights
  of the one-process run (that run is held to the JAX CLI's in
  test_torch_cli.py): all weights within ``RUN_L2`` relative L2 error,
  each within two learning rates per update (the sums run in another
  order, and Adam's first step of a rounding-noise gradient takes
  either sign), with the
  same metric log (``RUN_RTOL``) and prototype classes; ``eval-valid
  --mesh-data 2 --stats`` writes the one-process ``mean_iou.txt`` and
  ``iou_scores.json``; ``cls-train --mesh-data 2`` and
  ``unoise-train-util --mesh-data 2`` (2 epochs) end near the weights of
  their one-process runs (``--mesh-data 1``: under a mesh U-Noise drops
  the partial batch, as the JAX package does) within the limits the
  port's tests set for such runs against JAX (``LONG_RUN_L2``,
  ``CLI_LOSS_ATOL``, ``CLI_DICE_ATOL``).  ``eval-valid --stats
  --stats-upsampled`` and ``eval-test`` under ``--mesh-model 2`` (spatial
  eval: two ranks split image H) end within the eval tie budget of the
  one-process commands: mIoU and per-class IoU within what
  ``SPATIAL_TIE_PIXELS`` moved pixels can change, the PNGs in at most
  that many pixels; so does ``eval-valid --mesh-model 2`` of an MSC
  experiment (the trained run under ``msc_scales`` (0.5, 0.75)).  A
  rank count above the machine's cards exits saying so.
"""

import csv
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from adlm_tpu_torch import cli
from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.core.mesh import Mesh, MeshSpec, mesh_coords

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_L2 = 1e-5
RUN_RTOL = 1e-4   # tests/test_torch_train.py's METRIC_RTOL
# the multi-epoch runs: test_torch_classification.py's RUN_RTOL (its tiny
# run drifts from the JAX run by Adam's sign on rounding-noise gradients
# and the train-mode BN of 1x1 maps over 4 images; measured here: 3.7e-4
# on the classifier's parameters, 5.1e-3 on its running statistics,
# 3.8e-3 on the U-Net's weights), and test_torch_unoise.py's
# CLI_LOSS_ATOL / CLI_DICE_ATOL for the logged validation
LONG_RUN_L2 = 1e-2
CLI_LOSS_ATOL = 5e-3
CLI_DICE_ATOL = 5e-2
# two learning rates per update: smoke's largest lr (2.5e-4) over its 3
# updates; the classifier's (3e-3) over its 6; U-Noise's (3e-3) over 8
TRAIN_DRIFT = 2 * 2.5e-4 * 3
CLS_DRIFT = 2 * 3e-3 * 6
UNOISE_DRIFT = 2 * 3e-3 * 8
CMD_TIMEOUT_S = 180
# tests/test_torch_evaluate.py's TIE_BUDGET: pixels whose prediction may
# move between two summation orders of the same forward
SPATIAL_TIE_PIXELS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# MeshSpec and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,model,n", [(-1, 1, 8), (2, 2, 4), (4, 2, 8),
                                          (3, 1, 4), (-1, 3, 8)])
def test_mesh_spec_and_layout_match_jax(data, model, n):
    import jax

    from adlm_tpu.core.mesh import MeshSpec as JaxMeshSpec, make_mesh as jax_make_mesh

    devices = jax.devices()[:n]
    try:
        want = JaxMeshSpec(data=data, model=model).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match="mesh") as got:
            MeshSpec(data=data, model=model).resolve(n)
        assert str(got.value) == str(e)
        return
    assert MeshSpec(data=data, model=model).resolve(n) == want
    jmesh = jax_make_mesh(JaxMeshSpec(data=data, model=model), devices=devices)
    ids = np.vectorize(lambda d: devices.index(d))(jmesh.devices)
    np.testing.assert_array_equal(mesh_coords(*want), ids)
    for r in range(n):
        m = Mesh(*want, rank=r, device=torch.device("cpu"))
        assert ids[m.data_index, m.model_index] == r


def test_batch_slice_and_share():
    m = Mesh(2, 2, rank=3, device=torch.device("cpu"))   # data 1, model 1
    assert (m.data_index, m.model_index) == (1, 1)
    assert m.batch_slice(8) == slice(4, 8)
    assert [m.share(n, 4) for n in (8, 6, 4, 0)] == [4, 2, 0, 0]
    with pytest.raises(ValueError, match="divide"):
        m.batch_slice(5)
    # a world of one without a process group runs no collective
    t = torch.arange(3.0)
    assert m.all_reduce_(t) is t and m.gather_rows(t) is t


# ---------------------------------------------------------------------------
# the loaders' rank slices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_data(tmp_path_factory):
    from test_torch_pipeline import write_dataset

    return write_dataset(str(tmp_path_factory.mktemp("seg")), n=5, block=8)


@pytest.mark.parametrize("mode,n_jobs", [("thread", 1), ("thread", 2), ("process", 2)])
def test_superbatch_rank_slices_concatenate_to_the_stream(seg_data, mode, n_jobs):
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.data.dataset import SegmentationDataset
    from adlm_tpu_torch.data.pipeline import superbatch_iterator

    cfg = get_experiment("smoke").data
    ds = SegmentationDataset(cfg, cfg.train_key, data_path=seg_data)

    def stream(shard=None):
        return list(superbatch_iterator(ds, 2, 4, 2, seed=3, n_jobs=n_jobs, mode=mode,
                                        start_window=1, shard=shard))

    whole = stream()
    parts = [stream((k, 2)) for k in range(2)]
    for w, (images, labels) in enumerate(whole):
        assert parts[0][w][0].shape == (2, 2) + images.shape[2:]
        np.testing.assert_array_equal(np.concatenate([p[w][0] for p in parts], 1), images)
        np.testing.assert_array_equal(np.concatenate([p[w][1] for p in parts], 1), labels)


def test_eval_batches_rank_slices_concatenate_to_the_batches(seg_data):
    from adlm_tpu_torch.core.config import get_experiment
    from adlm_tpu_torch.data.dataset import SegmentationDataset

    cfg = get_experiment("smoke").data
    ds = SegmentationDataset(cfg, "val", data_path=seg_data, is_eval=True)
    for raw in (False, True):
        whole = list(ds.eval_batches(4, with_counts=True, raw=raw))
        parts = [list(ds.eval_batches(4, with_counts=True, raw=raw, shard=(k, 2)))
                 for k in range(2)]
        assert [b[2] for b in whole] == [4, 1]          # the padded tail
        for b, (images, labels, n) in enumerate(whole):
            assert all(p[b][2] == n for p in parts)
            np.testing.assert_array_equal(np.concatenate([p[b][0] for p in parts]), images)
            np.testing.assert_array_equal(np.concatenate([p[b][1] for p in parts]), labels)


def test_image_folder_and_unoise_rank_slices(tmp_path):
    from adlm_tpu_torch.data.image_folder import ImageFolderDataset
    from adlm_tpu_torch.data.unoise_data import batches, split_datasets
    from adlm_tpu_torch.interpret.visualize import write_png

    rng = np.random.RandomState(0)
    for c in ("a", "b"):
        os.makedirs(tmp_path / c)
        for i in range(3):
            write_png(str(tmp_path / c / f"{i}.png"),
                      rng.randint(0, 256, (20, 18, 3)).astype(np.uint8))
    ds = ImageFolderDataset(str(tmp_path), 16)
    whole = list(ds.batches(4, shuffle=True, seed=1, with_count=True))
    parts = [list(ds.batches(4, shuffle=True, seed=1, with_count=True, shard=(k, 2)))
             for k in range(2)]
    assert [b[2] for b in whole] == [4, 2]               # the wrapped tail
    for b, (images, labels, n) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[b][0] for p in parts]), images)
        np.testing.assert_array_equal(np.concatenate([p[b][1] for p in parts]), labels)
        assert all(p[b][2] == n for p in parts)

    train, _, _ = split_datasets(rng.rand(14, 12, 12).astype(np.float32),
                                 (rng.rand(14, 12, 12) > 0.5).astype(np.float32), raw=True)
    whole = list(batches(train, 4, shuffle=True, seed=2, drop_last=True, n_jobs=2))
    parts = [list(batches(train, 4, shuffle=True, seed=2, drop_last=True, shard=(k, 2)))
             for k in range(2)]
    assert len(whole) == len(train) // 4
    for b, (x, y) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[b][0] for p in parts]), x)
        np.testing.assert_array_equal(np.concatenate([p[b][1] for p in parts]), y)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run(argv, env, timeout=CMD_TIMEOUT_S):
    """A command in its own session, every process of it ended on a
    timeout."""
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"timed out: {argv}\n{out[-3000:]}")
    assert proc.returncode == 0, f"{argv} exited {proc.returncode}\n{out[-3000:]}"
    return out


def _env(results):
    env = dict(os.environ, RESULTS_DIR=str(results), PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def _module(*args):
    return [sys.executable, "-m", "adlm_tpu_torch.cli", *args]


def _assert_same_weights(a, b, stage, drift, l2=None, kind="last"):
    """``b``'s ``<stage>_<kind>`` against ``a``'s: every parameter entry
    within ``drift`` (two learning rates per update: Adam's first update
    of an entry whose gradient sits at rounding noise is ±lr·sign(g),
    either way), all entries (BN running statistics included) together
    within ``l2`` relative L2 error, the prototype classes equal."""
    pa, pb = CheckpointStore(a).restore(stage, kind), CheckpointStore(b).restore(stage, kind)
    sa, sb = pa["state_dict"], pb["state_dict"]
    assert set(sa) == set(sb)
    keys = [k for k in sa if sa[k].is_floating_point()]
    for k in keys:
        if "running" not in k:
            np.testing.assert_allclose(sb[k].float().numpy(), sa[k].float().numpy(),
                                       rtol=0, atol=drift, err_msg=f"{stage}: {k}")
    va = torch.cat([sa[k].float().flatten() for k in keys])
    vb = torch.cat([sb[k].float().flatten() for k in keys])
    err = float((va - vb).norm() / va.norm())
    assert err <= (RUN_L2 if l2 is None else l2), (stage, err)
    if "proto_class" in pa:
        assert torch.equal(pa["proto_class"].cpu(), pb["proto_class"].cpu())


def _metric_rows(run, name):
    with open(os.path.join(run, "logs", f"{name}_metrics.csv")) as f:
        return [{k: v for k, v in r.items() if not k.endswith("per_sec")}
                for r in csv.DictReader(f)]


def _assert_same_metrics(a, b, name):
    ra, rb = _metric_rows(a, name), _metric_rows(b, name)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        for k, v in x.items():
            if v in ("", None) or k in ("step", "phase", "split"):
                assert y[k] == v, k
            else:
                np.testing.assert_allclose(float(y[k]), float(v), rtol=RUN_RTOL, atol=1e-7,
                                           err_msg=k)


@pytest.fixture
def in_process(monkeypatch, tmp_path):
    """``cli.main`` in this process, its spawned ranks under a collective
    timeout and a bound on the whole run; ``RESULTS_DIR`` is
    ``tmp_path/results``."""
    from adlm_tpu_torch.core import mesh as mesh_mod

    spawn = mesh_mod.spawn_local

    def bounded(*args, **kwargs):
        kwargs.update(timeout_s=60.0, join_timeout=CMD_TIMEOUT_S)
        return spawn(*args, **kwargs)

    monkeypatch.setattr(mesh_mod, "spawn_local", bounded)
    results = tmp_path / "results"
    monkeypatch.setenv("RESULTS_DIR", str(results))
    return results


TRAIN = ["train", "smoke", "{run}", "--data-path", "{data}", "--steps-scale", "0.25",
         "--val-every", "1", "--push-batch-size", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, seg_data):
    """The one-process run and the 2-rank runs of the same ``train``: with
    ``--mesh-data 2`` (in this process, which spawns the ranks) and under
    ``torchrun`` (a subprocess)."""
    from adlm_tpu_torch.core import mesh as mesh_mod

    results = tmp_path_factory.mktemp("results")

    def argv(run):
        return [a.format(run=run, data=seg_data) for a in TRAIN]

    mp = pytest.MonkeyPatch()
    spawn = mesh_mod.spawn_local
    mp.setattr(mesh_mod, "spawn_local", lambda *a, **k: spawn(
        *a, **dict(k, timeout_s=60.0, join_timeout=CMD_TIMEOUT_S)))
    mp.setenv("RESULTS_DIR", str(results))
    try:
        cli.main(argv("one"))
        cli.main(argv("two") + ["--mesh-data", "2"])
    finally:
        mp.undo()
    _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc-per-node", "2", "-m", "adlm_tpu_torch.cli", *argv("torchrun"),
          "--distributed", "--mesh-data", "2"], _env(results))
    yield results
    shutil.rmtree(results, ignore_errors=True)   # 3 runs of checkpoints, about 1 GB


@pytest.mark.parametrize("run", ["two", "torchrun"])
def test_train_on_two_ranks_matches_one_process(trained, run):
    one, other = str(trained / "one"), str(trained / run)
    for stage in ("warmup", "nopush", "push"):
        _assert_same_weights(one, other, stage, TRAIN_DRIFT)
    _assert_same_metrics(one, other, "train")
    assert sorted(os.listdir(os.path.join(other, "prototypes"))) == sorted(
        os.listdir(os.path.join(one, "prototypes")))
    assert not [f for f in os.listdir(other) if f.startswith(".mesh_store")]


def test_eval_valid_on_two_ranks_matches_one_process(trained, seg_data, in_process):
    run = str(trained / "one")
    base = ["eval-valid", run, "push", "--data-path", seg_data, "--stats", "--examples", "0",
            "--batch-size", "2", "--device", "cpu"]
    outs = {}
    for tag, extra in (("one", []), ("two", ["--mesh-data", "2"])):
        cli.main(base + extra)
        ev = os.path.join(run, "evaluation", "push")
        outs[tag] = [open(os.path.join(ev, f)).read()
                     for f in ("mean_iou.txt", "iou_scores.json")]
    assert outs["one"] == outs["two"]


def test_eval_on_a_spatial_mesh_matches_one_process(trained, seg_data, in_process):
    from adlm_tpu_torch.data.image_folder import read_png

    run = str(trained / "one")
    ev_dir = os.path.join(run, "evaluation", "push")
    valid = ["eval-valid", run, "push", "--data-path", seg_data, "--stats",
             "--stats-upsampled", "--examples", "0", "--batch-size", "2", "--device", "cpu"]
    test = ["eval-test", run, "push", "--data-path", seg_data, "--split", "val",
            "--batch-size", "2", "--device", "cpu"]
    outs = {}
    for tag, extra in (("one", []), ("spatial", ["--mesh-model", "2"])):
        cli.main(valid + extra)
        with open(os.path.join(ev_dir, "mean_iou.txt")) as f:
            miou = float(f.read())
        with open(os.path.join(ev_dir, "iou_scores.json")) as f:
            ious = json.load(f)
        cli.main(test + extra)
        pngs = os.path.join(ev_dir, "test_predictions")
        outs[tag] = (miou, ious, {p: read_png(os.path.join(pngs, p))
                                  for p in sorted(os.listdir(pngs))})
    (m1, i1, p1), (m2, i2, p2) = outs["one"], outs["spatial"]
    assert sorted(p1) == sorted(p2) and len(p1) == 5
    assert sum(int((p1[k] != p2[k]).sum()) for k in p1) <= SPATIAL_TIE_PIXELS
    # a moved pixel changes a class's IoU by at most 100 / (its union - 1)
    # percentage points; every union here exceeds 1,000 pixels
    assert set(i1) == set(i2)
    for k in i1:
        assert abs(i1[k] - i2[k]) <= SPATIAL_TIE_PIXELS * 100 / 1000, k
    assert abs(m1 - m2) <= SPATIAL_TIE_PIXELS * 100 / 1000


def test_msc_eval_on_a_spatial_mesh_matches_one_process(trained, seg_data, in_process):
    """``eval-valid --mesh-model 2`` of an MSC experiment: the trained run
    with ``msc_scales`` (0.5, 0.75) in its config (MSC adds no weights),
    against the one-process command."""
    import dataclasses

    from adlm_tpu_torch.core.config import ExperimentConfig

    one = str(trained / "one")
    run = str(in_process.parent / "msc")
    shutil.copytree(os.path.join(one, "checkpoints"), os.path.join(run, "checkpoints"))
    store = CheckpointStore(run)
    cfg = ExperimentConfig.from_json(CheckpointStore(one).load_config_json())
    store.save_config(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, msc_scales=(0.5, 0.75))).to_json())
    ev_dir = os.path.join(run, "evaluation", "push")
    base = ["eval-valid", run, "push", "--data-path", seg_data, "--stats", "--stats-upsampled",
            "--examples", "0", "--batch-size", "2", "--device", "cpu"]
    outs = {}
    for tag, extra in (("one", []), ("spatial", ["--mesh-model", "2"])):
        cli.main(base + extra)
        with open(os.path.join(ev_dir, "mean_iou.txt")) as f:
            miou = float(f.read())
        with open(os.path.join(ev_dir, "iou_scores.json")) as f:
            outs[tag] = (miou, json.load(f))
    (m1, i1), (m2, i2) = outs["one"], outs["spatial"]
    # a moved pixel changes a class's IoU by at most 100 / (its union - 1)
    # percentage points; every union here exceeds 1,000 pixels
    assert set(i1) == set(i2)
    for k in i1:
        assert abs(i1[k] - i2[k]) <= SPATIAL_TIE_PIXELS * 100 / 1000, k
    assert abs(m1 - m2) <= SPATIAL_TIE_PIXELS * 100 / 1000


def test_more_ranks_than_cards_exits(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("RESULTS_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match="card"):
        cli.main(["train", "smoke", "r", "--mesh-data", "2"])


def test_cls_train_and_unoise_util_on_two_ranks_match_one_process(tmp_path, in_process):
    from adlm_tpu_torch.interpret.visualize import write_png

    rng = np.random.RandomState(0)
    for split, n in (("train", 3), ("test", 1)):
        for c in ("ant", "bee"):
            os.makedirs(tmp_path / split / c)
            for i in range(n):
                write_png(str(tmp_path / split / c / f"{i}.png"),
                          rng.randint(0, 256, (40, 36, 3)).astype(np.uint8))
    arrays = {"images": rng.rand(22, 16, 16).astype(np.float32),
              "masks": (rng.rand(22, 16, 16) > 0.7).astype(np.float32),
              "boxes": np.zeros((22, 4), np.int32)}
    for k, v in arrays.items():
        np.save(tmp_path / f"{k}.npy", v)
    results = in_process
    cls_args = ["cls-train", "{run}", "--train-dir", str(tmp_path / "train"),
                "--test-dir", str(tmp_path / "test"), "--arch", "resnet18", "--img-size", "32",
                "--prototypes", "4", "--proto-channels", "8", "--batch-size", "4",
                "--test-batch-size", "2", "--push-batch-size", "4", "--epochs", "2",
                "--warm-epochs", "1", "--push-start", "1", "--push-every", "1",
                "--last-layer-iterations", "1", "--device", "cpu"]
    util_args = ["unoise-train-util", "--imgs", str(tmp_path / "images.npy"),
                 "--masks", str(tmp_path / "masks.npy"), "--boxes", str(tmp_path / "boxes.npy"),
                 "--run-name", "{run}", "--depth", "2", "--channel-factor", "2",
                 "--epochs", "2", "--batch-size", "4", "--device", "cpu"]
    for args, run, one_extra in ((cls_args, "cls", []), (util_args, "util", ["--mesh-data", "1"])):
        cli.main([a.format(run=run + "1") for a in args] + one_extra)
        cli.main([a.format(run=run + "2") for a in args] + ["--mesh-data", "2"])
    _assert_same_weights(str(results / "cls1"), str(results / "cls2"), "nopush", CLS_DRIFT,
                         LONG_RUN_L2)
    assert (sorted(os.listdir(results / "cls1" / "checkpoints"))
            == sorted(os.listdir(results / "cls2" / "checkpoints")))
    for kind in ("last", "best"):
        _assert_same_weights(str(results / "util1"), str(results / "util2"), "utility",
                             UNOISE_DRIFT, LONG_RUN_L2, kind)
    for x, y in zip(_metric_rows(str(results / "util1"), "unoise_util"),
                    _metric_rows(str(results / "util2"), "unoise_util")):
        assert abs(float(x["val_loss"]) - float(y["val_loss"])) <= CLI_LOSS_ATOL
        assert abs(float(x["val_dice"]) - float(y["val_dice"])) <= CLI_DICE_ATOL
    shutil.rmtree(results, ignore_errors=True)
