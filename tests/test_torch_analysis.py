"""PyTorch port, the analyses: ``adlm_tpu_torch.interpret.analysis.
local_analysis`` and the ``analyze-local`` / ``analyze-global``
commands against the JAX package on shared weights (random, so the
last layer's own-class sanity check is mixed).

* ``local_analysis``: the grid prediction within ``TIE_BUDGET`` cells of
  JAX's; ``top_prototypes``, ``top_classes``, the sanity vector and the
  ``per_class`` order equal; activations within 1e-5; the artifact
  trees have the same file names, PNG pixels within 1 count of uint8
  (test_torch_visualize.py's rule: the cubic resize rounds differently
  in the last bits), each ``log.json`` equal with its floats within
  1e-5.
* Both CLIs on one tiny run of each package (test_torch_cli.py's
  layout): ``analyze-local`` prints the same JSON and links the same
  push-time artifacts through ``unique_prototypes.json``;
  ``analyze-global`` writes the same class ids.  ``_push_time_indices``
  equals the JAX package's on push and pruned runs.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from adlm_tpu import cli as jcli
from adlm_tpu.core.checkpoint import CheckpointStore as JaxStore
from adlm_tpu.interpret import analysis as jax_analysis
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.models.ppnet import default_proto_class as jax_proto_class

from adlm_tpu_torch import cli
from adlm_tpu_torch.core.checkpoint import CheckpointStore
from adlm_tpu_torch.interpret import analysis
from adlm_tpu_torch.interpret.visualize import write_png
from adlm_tpu_torch.models.ppnet import default_proto_class
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

from test_torch_evaluate import TIE_BUDGET
from test_torch_models import jax_pair, random_variables
from test_torch_pipeline import experiments, write_dataset
from test_torch_visualize import tree

P, K = 6, 3
SMOKE = dict(num_prototypes=P, num_classes=K, prototype_channels=8,
             deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny convs run op by op: one torch thread per test worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def assert_artifacts_match(got_dir, want_dir):
    """The same files; PNG pixels within 1 count, JSON equal with its
    floats within 1e-5, anything else byte for byte."""
    files = tree(want_dir)
    assert tree(got_dir) == files
    assert any(f.endswith(".png") for f in files)
    for rel in files:
        a, b = os.path.join(got_dir, rel), os.path.join(want_dir, rel)
        if rel.endswith(".png"):
            pa, pb = (np.asarray(Image.open(p)).astype(int) for p in (a, b))
            assert pa.shape == pb.shape, rel
            assert np.abs(pa - pb).max(initial=0) <= 1, rel
        elif rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                ja, jb = json.load(fa), json.load(fb)
            assert ja.keys() == jb.keys(), rel
            for key in ja:
                if key != "prototypes":
                    assert ja[key] == jb[key], (rel, key)
            for ea, eb in zip(ja["prototypes"], jb["prototypes"], strict=True):
                assert ea.keys() == eb.keys()
                for key in ea:
                    assert ea[key] == pytest.approx(eb[key], abs=1e-5), (rel, key)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("per_class_top", [0, 2])
def test_local_analysis_matches_jax(tmp_path, per_class_top):
    jm, params, constants, tm = jax_pair(seed=51 + per_class_top, **SMOKE)
    image = np.random.RandomState(5).rand(1, 65, 97, 3).astype(np.float32)
    kw = dict(top_k=4, per_class_top=per_class_top)
    want = jax_analysis.local_analysis(jm, params, constants, jax_proto_class(P, K), image,
                                       save_dir=str(tmp_path / "jax"), **kw)
    got = analysis.local_analysis(tm, default_proto_class(P, K), image,
                                  save_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert got["prediction"].shape == want["prediction"].shape == (9, 13)
    assert (got["prediction"] != want["prediction"]).sum() <= TIE_BUDGET
    for key in ("top_prototypes", "top_classes", "own_class_is_strongest"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # random last layer: the sanity check is mixed, so it is tested
    assert 0 < got["own_class_is_strongest"].sum() < P
    np.testing.assert_allclose(got["top_activations"], want["top_activations"], rtol=0,
                               atol=1e-5)
    if per_class_top:
        assert list(got["per_class"]) == list(want["per_class"])
        for c in want["per_class"]:
            np.testing.assert_array_equal(got["per_class"][c], want["per_class"][c])
    else:
        assert "per_class" not in got
    assert_artifacts_match(tmp_path / "port", tmp_path / "jax")
    # an overlay and a crop per top prototype, a folder per class section
    sections = len(got.get("per_class", {}))
    assert sections >= (1 if per_class_top else 0)
    assert len(os.listdir(tmp_path / "port")) == 8 + sections


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run directory per package with the same push_last weights,
    push-time artifacts and unique_prototypes.json, over a tiny
    dataset."""
    root = str(tmp_path_factory.mktemp("analysis"))
    data = write_dataset(os.path.join(root, "data"), n=3, block=8)
    jcfg, tcfg = experiments("tiny_port_analysis")
    params, consts = random_variables(JaxPPNet(cfg=jcfg.model), 53)
    pc = np.asarray(jax_proto_class(P, K))
    jrun, trun = os.path.join(root, "jax"), os.path.join(root, "port")
    JaxStore(jrun).save("push", "last", {"params": params, "constants": consts,
                                         "proto_class": pc, "step": np.int32(2)})
    JaxStore(jrun).save_config(jcfg.to_json())
    CheckpointStore(trun).save("push", "last", {
        "state_dict": state_dict_from_jax(params, consts),
        "proto_class": torch.from_numpy(pc.copy()), "step": 2})
    CheckpointStore(trun).save_config(tcfg.to_json())
    # push wrote its artifacts under the original indices of the
    # prototypes that dedup kept
    original = [0, 2, 3, 5, 7, 8]
    for run in (jrun, trun):
        os.makedirs(os.path.join(run, "prototypes", "epoch-push"))
        with open(os.path.join(run, "prototypes", "unique_prototypes.json"), "w") as f:
            json.dump(original, f)
        for j in original:
            write_png(os.path.join(run, "prototypes", "epoch-push",
                                   f"prototype-img_{j}-original.png"),
                      np.full((2, 3), j, np.uint8))
    return dict(root=root, data=data, jrun=jrun, trun=trun)


def test_analyze_local_and_global_match_jax(runs, capsys):
    local = ["push", "--data-path", runs["data"], "--index", "1", "--top-k", "3",
             "--per-class-top", "2"]
    jcli.main(["analyze-local", runs["jrun"]] + local)
    want = json.loads(capsys.readouterr().out)
    cli.main(["analyze-local", runs["trun"]] + local + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got == want
    out = os.path.join("local_analysis", "val1")
    assert_artifacts_match(os.path.join(runs["trun"], out), os.path.join(runs["jrun"], out))
    linked = sorted(f for f in os.listdir(os.path.join(runs["trun"], out))
                    if "prototype-img_" in f)
    original = [0, 2, 3, 5, 7, 8]
    assert linked == sorted(f"top-{r + 1}_prototype-img_{original[j]}-original.png"
                            for r, j in enumerate(got["top_prototypes"]))

    glob_args = ["push", "--data-path", runs["data"], "--split", "train", "--k", "2",
                 "--batch-size", "2"]
    jcli.main(["analyze-global", runs["jrun"]] + glob_args)
    want_line = capsys.readouterr().out
    cli.main(["analyze-global", runs["trun"]] + glob_args + ["--device", "cpu"])
    assert capsys.readouterr().out == want_line == "nearest patch class ids saved; shape (6, 2)\n"
    assert_npy_trees_equal(os.path.join(runs["trun"], "global_analysis"),
                           os.path.join(runs["jrun"], "global_analysis"))


def assert_npy_trees_equal(got_dir, want_dir):
    files = tree(want_dir)
    assert tree(got_dir) == files and "full_class_id.npy" in files
    for rel in files:
        np.testing.assert_array_equal(np.load(os.path.join(got_dir, rel)),
                                      np.load(os.path.join(want_dir, rel)), err_msg=rel)


def test_push_time_indices_match_jax(tmp_path):
    run = str(tmp_path)
    assert cli._push_time_indices(run, "push", 4) == jcli._push_time_indices(run, "push", 4) \
        == [0, 1, 2, 3]
    # pruned without prune_info: no map, never a wrong link
    assert cli._push_time_indices(run, "pruned", 4) is None
    np.save(os.path.join(run, "prune_info.npy"), np.asarray([[1, 0], [4, 2]]))
    for orig in (None, [0, 3, 4, 6, 9, 10]):
        if orig is not None:
            os.makedirs(os.path.join(run, "prototypes"))
            with open(os.path.join(run, "prototypes", "unique_prototypes.json"), "w") as f:
                json.dump(orig, f)
        for stage, n in (("pruned", 4), ("pruned", 5), ("push", 6), ("push", 7)):
            assert (cli._push_time_indices(run, stage, n)
                    == jcli._push_time_indices(run, stage, n)), (orig, stage, n)
    assert cli._push_time_indices(run, "pruned", 4) == [0, 4, 6, 10]


def test_local_analysis_takes_a_tensor_and_no_save_dir():
    _, _, _, tm = jax_pair(seed=57, **SMOKE)
    image = torch.from_numpy(np.random.RandomState(6).rand(1, 33, 33, 3).astype(np.float32))
    res = analysis.local_analysis(tm, torch.arange(P) // 2, image, top_k=P, device="cpu")
    assert sorted(res["top_prototypes"].tolist()) == list(range(P))
    assert np.all(np.diff(res["top_activations"]) <= 0)
    assert res["prediction"].shape == (5, 5)
