"""PyTorch port, the command line and its helpers: ``adlm_tpu_torch.cli``
against ``adlm_tpu.cli``, and the logging, TensorBoard and watchdog
copies against the JAX package's.

* One run directory per package holds the same ``push_last`` weights
  (random weights of the tiny model of test_torch_pipeline.py, carried
  by ``state_dict_from_jax``) beside the same ``config.json``, over
  test_torch_pipeline.py's dataset with labels in 8-pixel blocks.  On it,
  ``eval-valid --stats`` (grid and ``--stats-upsampled``), ``prune`` and
  ``eval-test`` of the pruned model run through both CLIs: ``mean_iou.txt``
  and ``iou_scores.json`` agree within ``IOU_ATOL`` (percentage points;
  both count the same pixels), the statistics handed to
  ``save_eval_plots`` (nearest-prototype counts exactly, top-K purity
  within ``PURITY_RTOL``: f32 sums
  of percentages in other orders), ``prune_info.npy`` and the pruned
  ``proto_class`` are equal, and the prediction PNGs decode to the same
  pixels as the JAX package's PIL files.
* ``train --pretrained`` with a torchvision-named state dict the test
  writes: the backbone after one warmup window (which leaves it frozen)
  equals ``load_deeplab_backbone`` of the JAX package followed by
  ``state_dict_from_jax``, and both loaders report the same keys.
* ``TBEventWriter`` files read back by the JAX package's
  ``read_scalars`` (and the other way round); ``RunLogger``'s CSV and
  log lines equal the JAX package's for the same calls.
* The watchdog cases of tests/test_watchdog.py on the port's copy, with
  fake child commands.
"""

import glob
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax

from adlm_tpu import cli as jcli
from adlm_tpu.core.checkpoint import CheckpointStore as JaxStore
from adlm_tpu.interpret import stats as jstats
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.models.ppnet import default_proto_class as jax_proto_class
from adlm_tpu.utils import logging as jlogging
from adlm_tpu.utils import tensorboard as jtb
from adlm_tpu.utils.torch_import import load_deeplab_backbone as jax_load_backbone

from adlm_tpu_torch import cli
from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.interpret import stats as tstats
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.utils import logging as tlogging
from adlm_tpu_torch.utils import tensorboard as ttb
from adlm_tpu_torch.utils import watchdog
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax
from adlm_tpu_torch.utils.torch_import import load_deeplab_backbone, torchvision_key_to_deeplab

from test_torch_models import random_variables
from test_torch_pipeline import experiments, write_dataset

IOU_ATOL = 1e-9
PURITY_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny convs run op by op: one torch thread per test worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# eval-valid, prune and eval-test against the JAX CLI
# ---------------------------------------------------------------------------

def _recorded(monkeypatch, module, into):
    """Keep what each ``save_eval_plots`` call receives, then write."""
    orig = module.save_eval_plots

    def record(out_dir, *args, **kwargs):
        into.append(kwargs)
        return orig(out_dir, *args, **kwargs)

    monkeypatch.setattr(module, "save_eval_plots", record)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    # labels in 8-pixel blocks: a patch holds one or a few classes, so
    # the prune's purity counts differ between prototypes
    data = write_dataset(os.path.join(root, "data"), block=8)
    jcfg, tcfg = experiments("tiny_port_cli")
    params, consts = random_variables(JaxPPNet(cfg=jcfg.model), 43)
    pc = np.asarray(jax_proto_class(6, 3))
    jrun, trun = os.path.join(root, "jax"), os.path.join(root, "port")
    JaxStore(jrun).save("push", "last", {"params": params, "constants": consts,
                                         "proto_class": pc, "step": np.int32(2)})
    JaxStore(jrun).save_config(jcfg.to_json())
    CheckpointStore(trun).save("push", "last", {
        "state_dict": state_dict_from_jax(params, consts),
        "proto_class": torch.from_numpy(pc.copy()), "step": 2})
    CheckpointStore(trun).save_config(tcfg.to_json())
    return dict(root=root, data=data, jrun=jrun, trun=trun)


def _read_eval(run, stage):
    out = os.path.join(run, "evaluation", stage)
    with open(os.path.join(out, "mean_iou.txt")) as f:
        miou = float(f.read())
    with open(os.path.join(out, "iou_scores.json")) as f:
        return miou, json.load(f)


@pytest.mark.parametrize("mode", ["grid", "upsampled"])
def test_eval_valid_matches_jax(runs, monkeypatch, capsys, mode):
    args = ["push", "--split", "val", "--data-path", runs["data"], "--stats",
            "--batch-size", "2", "--examples", "0"]
    if mode == "upsampled":
        args.append("--stats-upsampled")
    jseen, tseen = [], []
    _recorded(monkeypatch, jstats, jseen)
    _recorded(monkeypatch, tstats, tseen)
    jcli.main(["eval-valid", runs["jrun"]] + args)
    want = json.loads(capsys.readouterr().out)
    cli.main(["eval-valid", runs["trun"]] + args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got["stats_mode"] == want["stats_mode"] == mode
    (tm, tious), (jm, jious) = _read_eval(runs["trun"], "push"), _read_eval(runs["jrun"], "push")
    assert abs(tm - jm) <= IOU_ATOL and set(tious) == set(jious)
    assert all(abs(tious[k] - jious[k]) <= IOU_ATOL for k in jious)
    assert got["pixel_accuracy"] == pytest.approx(want["pixel_accuracy"], abs=IOU_ATOL)
    (t,), (j,) = tseen, jseen
    np.testing.assert_array_equal(t["stats"]["nearest_proto_counts"],
                                  j["stats"]["nearest_proto_counts"])
    assert t["stats"]["nearest_proto_counts"].sum() > 0
    np.testing.assert_allclose(t["stats"]["mean_top_k_purity"],
                               j["stats"]["mean_top_k_purity"], rtol=PURITY_RTOL)
    np.testing.assert_allclose(t["pair_stats"]["same_class_distances"],
                               j["pair_stats"]["same_class_distances"], rtol=1e-6)


def test_prune_and_eval_test_match_jax(runs, capsys):
    from PIL import Image

    prune = ["--data-path", runs["data"], "--k", "3", "--threshold", "2",
             "--batch-size", "2"]
    jcli.main(["prune", runs["jrun"]] + prune)
    cli.main(["prune", runs["trun"]] + prune + ["--device", "cpu"])
    tinfo = np.load(os.path.join(runs["trun"], "prune_info.npy"))
    jinfo = np.load(os.path.join(runs["jrun"], "prune_info.npy"))
    np.testing.assert_array_equal(tinfo, jinfo)
    assert 0 < len(tinfo) < 6, tinfo   # some pruned, some kept
    tp = CheckpointStore(runs["trun"]).restore("pruned", "last")
    jp = JaxStore(runs["jrun"]).restore("pruned", "last")
    assert tp["proto_class"].tolist() == np.asarray(jp["proto_class"]).tolist()
    want = state_dict_from_jax(jp["params"], jp["constants"])
    assert set(tp["state_dict"]) == set(want)
    for k, w in want.items():
        assert torch.equal(tp["state_dict"][k], w), k
    assert tp["step"] == 2

    test = ["pruned", "--split", "val", "--data-path", runs["data"], "--max-images", "3"]
    jcli.main(["eval-test", runs["jrun"]] + test)
    cli.main(["eval-test", runs["trun"]] + test + ["--device", "cpu"])
    capsys.readouterr()
    pred_dir = os.path.join("evaluation", "pruned", "test_predictions")
    names = sorted(os.listdir(os.path.join(runs["trun"], pred_dir)))
    assert names == sorted(os.listdir(os.path.join(runs["jrun"], pred_dir)))
    assert names == ["val0.png", "val1.png", "val2.png"]
    for name in names:
        with Image.open(os.path.join(runs["trun"], pred_dir, name)) as a, \
                Image.open(os.path.join(runs["jrun"], pred_dir, name)) as b:
            assert a.mode == b.mode and a.size == b.size == (48, 40)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


# ---------------------------------------------------------------------------
# --pretrained
# ---------------------------------------------------------------------------

def _torchvision_key(dl_key):
    """deeplab key → torchvision ResNet key (the inverse of
    ``torchvision_key_to_deeplab``)."""
    seg = dl_key.split(".")
    if seg[0] == "layer1":           # layer1.conv1.{conv,bn}.x
        return {"conv": "conv1", "bn": "bn1"}[seg[2]] + "." + seg[3]
    layer, block = int(seg[0][5:]) - 1, int(seg[1][5:]) - 1
    if seg[2] == "shortcut":
        return f"layer{layer}.{block}.downsample.{dict(conv=0, bn=1)[seg[3]]}.{seg[4]}"
    num = {"reduce": 1, "conv3x3": 2, "increase": 3}[seg[2]]
    return f"layer{layer}.{block}.{seg[3]}{num}.{seg[4]}"


def test_pretrained_backbone_through_the_cli(tmp_path, monkeypatch):
    data = write_dataset(str(tmp_path / "data"))
    jcfg, tcfg = experiments("tiny_port_pretrained")
    g = torch.Generator().manual_seed(47)
    sd = {}
    for k, v in PPNet(tcfg.model).state_dict().items():
        if k.startswith("features.base.layer"):
            sd[_torchvision_key(k[len("features.base."):])] = (
                torch.rand(v.shape, generator=g) + 0.5 if k.endswith("running_var")
                else torch.randn(v.shape, generator=g))
    sd["fc.weight"] = torch.randn(10, 2048, generator=g)
    sd["bn1.num_batches_tracked"] = torch.tensor(7)
    sd["layer4.0.conv2.weight"] = torch.randn(3, 3, 3, 3, generator=g)  # wrong shape
    path = str(tmp_path / "resnet.pth")
    torch.save(sd, path)

    # the JAX loader's result as the port's state_dict
    shapes = jax.eval_shape(lambda: JaxPPNet(cfg=jcfg.model).init(
        jax.random.PRNGKey(0), np.zeros((1, 33, 33, 3), np.float32)))
    p_host = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    c_host = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["constants"])
    jreport = jax_load_backbone(p_host, c_host, {k: v.numpy() for k, v in sd.items()})
    want = state_dict_from_jax(p_host, c_host)
    report = load_deeplab_backbone(PPNet(tcfg.model).state_dict(), sd)
    assert report == jreport
    assert report["unexpected_keys"] == ["layer4.0.conv2.weight"]
    npz = str(tmp_path / "resnet.npz")
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    with np.load(npz) as z:
        assert load_deeplab_backbone(PPNet(tcfg.model).state_dict(),
                                     {k: z[k] for k in z.files}) == report

    monkeypatch.setenv("RESULTS_DIR", str(tmp_path / "results"))
    cli.main(["train", tcfg.name, "pre", "--pretrained", path, "--data-path", data,
              "--halt-after", "1", "--val-every", "100", "--device", "cpu"])
    got = CheckpointStore(str(tmp_path / "results" / "pre")).restore(
        "warmup", "last")["state_dict"]
    # the warmup trains add-ons, ASPP and prototypes: the backbone stays
    # as loaded
    loaded = {"features.base." + torchvision_key_to_deeplab(k) for k in report["loaded"]}
    assert len(loaded) == len(report["loaded"]) > 0
    for k in loaded:
        assert torch.equal(got[k], want[k]), k
    n = len(loaded)
    with open(str(tmp_path / "results" / "pre" / "logs" / "train.log")) as f:
        assert f"Loaded {n} tensors (1 unexpected)" in f.read()


# ---------------------------------------------------------------------------
# logging and TensorBoard
# ---------------------------------------------------------------------------

def _log_calls(logger):
    logger.log("WARM-UP TRAINING START (4 steps)")
    logger.metrics(0, "warmup", "train", {"loss": 1.25, "accuracy": 0.5,
                                          "steps_per_sec": 3.0})
    logger.metrics(1, "warmup", "val", {"loss": 0.8, "l1": 1e-4, "accuracy": 0.25})
    logger.metrics(2, "nopush", "train", {"loss": 0.7, "accuracy": 0.75})
    logger.log("warmup: new best val accuracy 0.2500")
    logger.close()


def test_run_logger_writes_what_jax_writes(tmp_path):
    jrun, trun = str(tmp_path / "jax"), str(tmp_path / "port")
    _log_calls(jlogging.RunLogger(jrun))
    _log_calls(tlogging.RunLogger(trun))
    for name in ("train_metrics.csv", "train.log"):
        with open(os.path.join(trun, "logs", name)) as f, \
                open(os.path.join(jrun, "logs", name)) as g:
            got, want = f.read().splitlines(), g.read().splitlines()
        if name == "train.log":   # "[<timestamp>] message"
            got = [ln.split("] ", 1)[1] for ln in got]
            want = [ln.split("] ", 1)[1] for ln in want]
        assert got == want, name
    tfiles = glob.glob(os.path.join(trun, "logs", "tb", "events.out.tfevents.*"))
    jfiles = glob.glob(os.path.join(jrun, "logs", "tb", "events.out.tfevents.*"))
    assert jtb.read_scalars(tfiles[0]) == jtb.read_scalars(jfiles[0])
    assert jtb.read_scalars(tfiles[0])["val/warmup/l1"] == [(1, pytest.approx(1e-4))]


def test_tb_event_files_read_back_across_packages(tmp_path):
    for writer, reader in ((ttb.TBEventWriter, jtb.read_scalars),
                           (jtb.TBEventWriter, ttb.read_scalars)):
        d = str(tmp_path / writer.__module__)
        w = writer(d)
        w.add_scalars(1, {"train/loss": 0.5, "train/lr": 1e-3})
        w.add_scalar(3, "val/accuracy", 0.9)
        w.close()
        (f,) = glob.glob(os.path.join(d, "events.out.tfevents.*"))
        got = reader(f)
        assert got["train/loss"] == [(1, 0.5)]
        assert got["val/accuracy"] == [(3, 0.8999999761581421)]
    assert ttb._crc32c(b"123456789") == 0xE3069283


# ---------------------------------------------------------------------------
# the watchdog (tests/test_watchdog.py on the port's copy)
# ---------------------------------------------------------------------------

def _child_script(tmp_path):
    """argv: <state_dir> <mode of attempt 0>.  Attempts ≥ 1 heartbeat
    once and exit 0 (the resumed run completes)."""
    path = tmp_path / "child.py"
    path.write_text("""
import os, sys, time
state, mode = sys.argv[1], sys.argv[2]
hb = os.path.join(state, "hb.log")
af = os.path.join(state, "attempt")
attempt = int(open(af).read()) if os.path.exists(af) else 0
open(af, "w").write(str(attempt + 1))
open(hb, "a").write(f"attempt {attempt}\\n")
if attempt == 0:
    if mode == "hang":
        time.sleep(600)   # alive but no further heartbeats
    sys.exit(3)           # crash
sys.exit(0)
""")
    return str(path)


def _mk(tmp_path, mode):
    script = _child_script(tmp_path)
    return ((lambda attempt: [sys.executable, script, str(tmp_path), mode]),
            [os.path.join(str(tmp_path), "hb.log")])


@pytest.mark.parametrize("mode", ["hang", "crash"])
def test_watchdog_kills_a_stall_and_restarts_a_crash(tmp_path, mode):
    make_cmd, hb = _mk(tmp_path, mode)
    probes = []
    rc = watchdog.run_with_watchdog(make_cmd, hb, timeout_s=8.0, poll_s=0.3,
                                    max_restarts=2, grace_s=5.0,
                                    probe=lambda: probes.append(1) or True,
                                    log=lambda *a: None)
    assert rc == 0
    assert int((tmp_path / "attempt").read_text()) == 2   # one restart
    assert probes   # the device was probed before the relaunch


@pytest.mark.parametrize("exit_code, restarts", [(5, [0, 1]), (86, [0])])
def test_watchdog_budget_and_divergence(tmp_path, exit_code, restarts):
    script = tmp_path / "fail.py"
    script.write_text(f"import sys; sys.exit({exit_code})")
    calls = []

    def make_cmd(attempt):
        calls.append(attempt)
        return [sys.executable, str(script)]

    rc = watchdog.run_with_watchdog(make_cmd, [], timeout_s=30, poll_s=0.1,
                                    max_restarts=1 if exit_code == 5 else 5,
                                    probe=lambda: True, log=lambda *a: None)
    assert rc == exit_code and calls == restarts


def test_wait_for_device_and_the_default_probe(tmp_path):
    flips = iter([False, False, True])
    assert watchdog.wait_for_device(lambda: next(flips), poll_s=0.01,
                                    max_wait_s=10, log=lambda *a: None)
    assert not watchdog.wait_for_device(lambda: False, poll_s=0.01,
                                        max_wait_s=0.05, log=lambda *a: None)
    # the default probe is a CUDA round trip in a subprocess
    assert watchdog.default_device_probe(120.0) == torch.cuda.is_available()
    assert watchdog.newest_mtime([str(tmp_path / "missing")]) is None
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_text("x")
    time.sleep(0.01)
    b.write_text("y")
    assert watchdog.newest_mtime([str(a), str(b)]) == os.stat(b).st_mtime


def test_relaunch_resumes_only_once_resume_json_exists(tmp_path):
    argv = ["train", "exp", "run", "--auto-restart", "3", "--bf16",
            "--watchdog-timeout=60", "--val-every", "10"]
    base = cli._strip_valued_flags(argv, ("--auto-restart", "--watchdog-timeout"))
    assert base == ["train", "exp", "run", "--bf16", "--val-every", "10"]
    run_dir = str(tmp_path)
    first = cli._watchdog_relaunch_cmd(base, run_dir, 0)
    assert first[:3] == [sys.executable, "-m", "adlm_tpu_torch.cli"]
    assert "--resume" not in first
    assert "--resume" not in cli._watchdog_relaunch_cmd(base, run_dir, 1)
    with open(os.path.join(run_dir, "resume.json"), "w") as f:
        f.write("{}")
    assert cli._watchdog_relaunch_cmd(base, run_dir, 1).count("--resume") == 1
    assert cli._watchdog_relaunch_cmd(base + ["--resume"], run_dir, 2).count("--resume") == 1
