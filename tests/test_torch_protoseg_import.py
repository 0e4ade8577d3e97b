"""PyTorch port, ProtoSeg checkpoint interop: ``import-protoseg`` and
``export-torch`` of ``adlm_tpu_torch.cli`` against ``adlm_tpu.cli``.

The test writes its own reference-layout checkpoint of the ``smoke``
experiment (deeplab-named backbone under ``features.base`` with torch
BN's ``num_batches_tracked``, ``prototype_vectors`` (P, C, 1, 1),
``ones``, a bias-free ``last_layer``; reference model.py:54-143) from
seeded numpy values, once as a plain state_dict and once as a pickled
module carrying ``prototype_class_identity``, as the reference saves
its stages (reference segmentation/train.py:60-65).  Both packages
import it:

* the imported weights are equal bit for bit (the JAX run's through
  ``state_dict_from_jax``), and equal the file's;
* both ``export-torch`` files have the same keys and bit-equal values,
  and an export re-imports bit-equal;
* a pruned checkpoint without an identity exits with the JAX package's
  message unless ``--proto-class`` names one; a bare ``--out`` works;
* ``eval-valid`` (whole-image, and ``--windowed`` with statistics) and
  ``eval-test --windowed`` on the imported runs agree with the JAX
  package's within the tie budget of test_torch_evaluate.py, and
  ``--windowed`` with ``--stats-upsampled`` is refused as JAX refuses it.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from adlm_tpu import cli as jcli
from adlm_tpu.core.checkpoint import CheckpointStore as JaxStore

from adlm_tpu_torch import cli
from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.core.config import get_experiment
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

from test_torch_evaluate import TIE_BUDGET
from test_torch_pipeline import write_dataset

P, K = 6, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny convs run op by op: one torch thread per test worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class RefModule(nn.Module):
    """A module whose state_dict is ``sd`` key for key (nested children
    by the dotted names), with the reference's one-hot
    ``prototype_class_identity`` attribute: what ``torch.save(ppnet)``
    pickles."""

    def __init__(self, sd, identity):
        super().__init__()
        for key, value in sd.items():
            *path, leaf = key.split(".")
            mod = self
            for name in path:
                if not hasattr(mod, name):
                    mod.add_module(name, nn.Module())
                mod = getattr(mod, name)
            mod.register_buffer(leaf, value)
        self.prototype_class_identity = identity


def reference_state_dict(seed):
    """The smoke PPNet's reference state_dict from seeded numpy values:
    BN running variances in [0.5, 1.5), a num_batches_tracked per BN."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, v in PPNet(get_experiment("smoke").model).state_dict().items():
        if key == "ones":
            val = np.ones(v.shape)
        elif key.endswith("running_var"):
            val = rng.uniform(0.5, 1.5, v.shape)
        elif key.endswith(".weight") and v.ndim == 4:
            val = rng.normal(0.0, 1.0 / np.sqrt(np.prod(v.shape[1:])), v.shape)
        else:
            val = rng.uniform(-0.5, 1.0, v.shape)
        sd[key] = torch.from_numpy(val.astype(np.float32))
        if key.endswith("bn.running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("protoseg_import")
    sd = reference_state_dict(3)
    identity = torch.zeros(P, K)
    identity[torch.arange(P), torch.arange(P) // 2] = 1
    torch.save(sd, root / "ref_sd.pth")
    torch.save(RefModule(sd, identity), root / "ref_module.pth")
    pruned = dict(sd, prototype_vectors=sd["prototype_vectors"][:5], ones=sd["ones"][:5])
    pruned["last_layer.weight"] = sd["last_layer.weight"][:, :5]
    torch.save(pruned, root / "pruned.pth")
    np.save(root / "pc.npy", np.asarray([0, 0, 1, 2, 2], np.int32))
    data = write_dataset(str(root / "data"), n=2)
    return dict(root=root, sd=sd, data=data)


def _import_both(files, monkeypatch, ckpt, name, *extra):
    """(JAX run dir, port run dir) of one checkpoint."""
    root = files["root"]
    monkeypatch.setenv("RESULTS_DIR", str(root / "jax"))
    jcli.main(["import-protoseg", "smoke", name, str(root / ckpt), *extra])
    monkeypatch.setenv("RESULTS_DIR", str(root / "port"))
    cli.main(["import-protoseg", "smoke", name, str(root / ckpt), *extra, "--device", "cpu"])
    return str(root / "jax" / name), str(root / "port" / name)


def _assert_same_state_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("ckpt", ["ref_sd.pth", "ref_module.pth"])
def test_import_protoseg_matches_jax(files, monkeypatch, capsys, ckpt):
    jrun, trun = _import_both(files, monkeypatch, ckpt, "imp_" + ckpt[4:-4])
    capsys.readouterr()
    for kind in ("last", "best"):
        jp = JaxStore(jrun).restore("push", kind)
        tp = CheckpointStore(trun).restore("push", kind)
        _assert_same_state_dict(tp["state_dict"],
                                state_dict_from_jax(jp["params"], jp["constants"]))
        assert tp["proto_class"].tolist() == np.asarray(jp["proto_class"]).tolist() \
            == [0, 0, 1, 1, 2, 2]
        assert tp["step"] == int(jp["step"]) == 0
    for k, v in files["sd"].items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(tp["state_dict"][k], v), k
    with open(os.path.join(trun, "config.json")) as f, \
            open(os.path.join(jrun, "config.json")) as g:
        assert json.load(f) == json.load(g)


def test_export_torch_matches_jax_and_round_trips(files, monkeypatch, capsys):
    jrun, trun = _import_both(files, monkeypatch, "ref_module.pth", "exp")
    jcli.main(["export-torch", jrun, "push"])
    cli.main(["export-torch", trun, "push", "--device", "cpu"])
    capsys.readouterr()
    rel = os.path.join("export_torch", "push_best")
    got = torch.load(os.path.join(trun, rel + ".pth"), weights_only=True)
    want = torch.load(os.path.join(jrun, rel + ".pth"), weights_only=True)
    _assert_same_state_dict(got, want)
    # the reference's exact key set, without BN bookkeeping
    assert set(got) == {k for k in files["sd"] if not k.endswith("num_batches_tracked")}
    for suffix in ("_proto_class.npy",):
        a, b = (np.load(os.path.join(r, rel + suffix)) for r in (trun, jrun))
        assert a.dtype == b.dtype and a.tolist() == b.tolist() == [0, 0, 1, 1, 2, 2]

    # the round trip: the export re-imports bit-equal
    monkeypatch.setenv("RESULTS_DIR", str(files["root"] / "port"))
    cli.main(["import-protoseg", "smoke", "again", os.path.join(trun, rel + ".pth"),
              "--device", "cpu"])
    capsys.readouterr()
    again = CheckpointStore(str(files["root"] / "port" / "again")).restore("push", "best")
    first = CheckpointStore(trun).restore("push", "best")
    _assert_same_state_dict(again["state_dict"], first["state_dict"])
    assert torch.equal(again["proto_class"], first["proto_class"])


def test_import_pruned_needs_proto_class(files, monkeypatch, capsys):
    root = files["root"]
    monkeypatch.setenv("RESULTS_DIR", str(root / "jax"))
    with pytest.raises(SystemExit) as want:
        jcli.main(["import-protoseg", "smoke", "pruned", str(root / "pruned.pth"),
                   "--stage", "pruned"])
    monkeypatch.setenv("RESULTS_DIR", str(root / "port"))
    with pytest.raises(SystemExit) as got:
        cli.main(["import-protoseg", "smoke", "pruned", str(root / "pruned.pth"),
                  "--stage", "pruned", "--device", "cpu"])
    assert "--proto-class" in str(got.value)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(root / "port" / "pruned")

    jrun, trun = _import_both(files, monkeypatch, "pruned.pth", "pruned_ok",
                              "--stage", "pruned", "--proto-class", str(root / "pc.npy"))
    capsys.readouterr()
    tp = CheckpointStore(trun).restore("pruned", "best")
    jp = JaxStore(jrun).restore("pruned", "best")
    assert tp["proto_class"].tolist() == [0, 0, 1, 2, 2]
    _assert_same_state_dict(tp["state_dict"],
                            state_dict_from_jax(jp["params"], jp["constants"]))
    assert tp["state_dict"]["prototype_vectors"].shape == (5, 8, 1, 1)


def test_export_torch_bare_out_filename(files, monkeypatch, capsys):
    _, trun = _import_both(files, monkeypatch, "ref_sd.pth", "bare")
    monkeypatch.chdir(files["root"])
    cli.main(["export-torch", trun, "push", "--out", "bare.pth", "--device", "cpu"])
    capsys.readouterr()
    assert os.path.exists(files["root"] / "bare.pth")
    assert np.load(files["root"] / "bare_proto_class.npy").tolist() == [0, 0, 1, 1, 2, 2]


def _eval_valid(main, run, data, capsys, seen, *extra):
    """eval-valid's printed results and the (intersection, union) its
    evaluator reduced to the mIoU."""
    main(["eval-valid", run, "push", "--split", "val", "--data-path", data,
          "--examples", "0", *extra])
    return json.loads(capsys.readouterr().out), seen.pop()


@pytest.fixture
def confusion(monkeypatch):
    """Every (intersection, union) handed to either package's
    ``mean_iou_from_confusion``."""
    from adlm_tpu.interpret import evaluate as jax_eval
    from adlm_tpu_torch.interpret import evaluate as port_eval
    from adlm_tpu_torch.interpret import windowed as port_win

    seen = []
    for module in (jax_eval, port_eval, port_win):
        orig = module.mean_iou_from_confusion

        def record(inter, union, orig=orig):
            seen.append((np.asarray(inter, np.int64), np.asarray(union, np.int64)))
            return orig(inter, union)

        monkeypatch.setattr(module, "mean_iou_from_confusion", record)
    return seen


@pytest.mark.parametrize("mode", ["whole", "windowed"])
def test_eval_on_imported_run_matches_jax(files, monkeypatch, capsys, confusion, mode):
    jrun, trun = _import_both(files, monkeypatch, "ref_module.pth", "ev_" + mode)
    capsys.readouterr()
    data = files["data"]
    extra = ["--windowed", "33,33", "--stats", "--batch-size", "2"] if mode == "windowed" else []
    want, (ji, ju) = _eval_valid(jcli.main, jrun, data, capsys, confusion, *extra)
    got, (ti, tu) = _eval_valid(cli.main, trun, data, capsys, confusion, *extra,
                                "--device", "cpu")
    assert np.abs(ti - ji).sum() <= TIE_BUDGET and np.abs(tu - ju).sum() <= TIE_BUDGET
    assert ju.sum() > 0
    if (ti == ji).all() and (tu == ju).all():
        assert got["mean_iou"] == pytest.approx(want["mean_iou"], abs=1e-9)
        assert got["pixel_accuracy"] == pytest.approx(want["pixel_accuracy"], abs=1e-9)
    assert got.get("stats_mode") == want.get("stats_mode")
    if mode == "whole":
        return
    assert got["stats_mode"] == "grid"
    with pytest.raises(SystemExit) as refused:
        cli.main(["eval-valid", trun, "push", "--data-path", data, "--windowed", "33,33",
                  "--stats-upsampled", "--device", "cpu"])
    with pytest.raises(SystemExit) as jax_refused:
        jcli.main(["eval-valid", jrun, "push", "--data-path", data, "--windowed", "33,33",
                   "--stats-upsampled"])
    assert str(refused.value) == str(jax_refused.value)

    test = ["push", "--split", "val", "--data-path", data, "--windowed", "33,33"]
    jcli.main(["eval-test", jrun] + test)
    cli.main(["eval-test", trun] + test + ["--device", "cpu"])
    capsys.readouterr()
    pred_dir = os.path.join("evaluation", "push", "test_predictions")
    names = sorted(os.listdir(os.path.join(trun, pred_dir)))
    assert names == sorted(os.listdir(os.path.join(jrun, pred_dir))) == ["val0.png", "val1.png"]
    for name in names:
        with Image.open(os.path.join(trun, pred_dir, name)) as a, \
                Image.open(os.path.join(jrun, pred_dir, name)) as b:
            assert a.mode == b.mode and a.size == b.size == (48, 40)
            assert (np.asarray(a) != np.asarray(b)).sum() <= TIE_BUDGET, name


def test_load_protoseg_model_reports_like_jax(files):
    """The port's loader and the JAX package's name the same keys loaded,
    unexpected (an odd add-on index, a stray key) and corrupt."""
    import jax
    import jax.numpy as jnp

    from adlm_tpu.core.config import get_experiment as jax_experiment
    from adlm_tpu.models.ppnet import PPNet as JaxPPNet
    from adlm_tpu.utils.torch_import import load_protoseg_model as jax_load
    from adlm_tpu.utils.torch_import import nan_template

    from adlm_tpu_torch.utils.torch_import import load_protoseg_model

    sd = {k: v.clone() for k, v in files["sd"].items()}
    sd["add_on_layers.1.weight"] = torch.ones(3)
    sd["features.base.layer1.conv1.bn.running_var"][0] = -1.0
    sd["stray"] = torch.zeros(2)
    template = nan_template(JaxPPNet(cfg=jax_experiment("smoke").model),
                            jnp.zeros((1, 65, 65, 3), jnp.float32))
    params = jax.tree.map(np.asarray, template["params"])
    constants = jax.tree.map(np.asarray, template.get("constants", {}))
    want = jax_load(params, constants, {k: v.numpy() for k, v in sd.items()})
    got = load_protoseg_model(PPNet(get_experiment("smoke").model).state_dict(), sd)
    for key in ("loaded", "unexpected_keys", "negative_variance_keys"):
        assert sorted(got[key]) == sorted(want[key]), key
    assert "stray" in got["unexpected_keys"]
    assert got["negative_variance_keys"] == ["features.base.layer1.conv1.bn.running_var"]


def test_refusals_name_no_completed_roadmap_item():
    """The port's CLI cites open roadmap items only (11)."""
    import inspect
    import re

    cited = set(re.findall(r"Queue 1 item (\d+[a-z]?)", inspect.getsource(cli)))
    assert cited <= {"11"}, cited
