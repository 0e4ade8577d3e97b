"""PyTorch port, the slice as a whole: full-resolution eval against the
JAX package on shared weights (``jax_pair`` of test_torch_models.py).

``make_inference_fn`` of both packages runs on the same numpy batch —
without stats, with grid stats and with upsampled stats (f32, and
``stats_exact``) — and ``SegEvaluator`` over two batches.  Budgets:

* I/U/correct/total: within ``TIE_BUDGET`` pixels (XLA and PyTorch sum
  in other orders, which may flip an argmax between near-equal
  logits, as in tests/test_eval_golden.py);
* ``agree_counts``: summed absolute difference ≤ 2·``TIE_BUDGET``;
* ``topk_purity``: atol 1e-3 (stable argsort on both sides);
* mIoU: within 1e-6 plus what the differing counters can move it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adlm_tpu.interpret import evaluate as jax_eval
from adlm_tpu.interpret.stats import ProtoStatsAccumulator as JaxAccumulator
from adlm_tpu.models.ppnet import default_proto_class as jax_proto_class

from adlm_tpu_torch.interpret import evaluate as port_eval
from adlm_tpu_torch.interpret.stats import (
    ProtoStatsAccumulator,
    prototype_pair_distances,
)
from adlm_tpu_torch.models.ppnet import default_proto_class

from test_torch_models import jax_pair

TIE_BUDGET = 4
K, P = 4, 12
MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _batch(seed, B=2, H=65, W=97, raw=False):
    rng = np.random.RandomState(seed)
    images = (rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8) if raw
              else rng.rand(B, H, W, 3).astype(np.float32))
    labels = rng.randint(0, K + 1, size=(B, H, W)).astype(np.int32)
    labels[0, :5] = 0  # a void stripe
    u = rng.rand(B, 16).astype(np.float32)
    v = rng.rand(B, 16).astype(np.float32)
    return images, labels, u, v


def _assert_counters_close(got, want):
    assert int(got["total"]) == int(want["total"])  # the void mask is exact
    assert abs(int(got["correct"]) - int(want["correct"])) <= TIE_BUDGET
    for key in ("intersection", "union"):
        diff = np.abs(got[key].numpy() - np.asarray(want[key]))
        assert diff.sum() <= TIE_BUDGET, (key, got[key], want[key])


STATS = {
    "no_stats": dict(),
    "grid_stats": dict(with_stats=True),
    "upsampled": dict(with_stats=True, stats_upsampled=True),
    "upsampled_exact": dict(with_stats=True, stats_upsampled=True,
                            stats_exact=True),
    "upsampled_uint8": dict(with_stats=True, stats_upsampled=True,
                            normalize=MEAN_STD),
}


@pytest.mark.parametrize("case", sorted(STATS))
def test_inference_fn_matches_jax(case):
    kw = STATS[case]
    jm, params, constants, tm = jax_pair(seed=21)
    images, labels, u, v = _batch(4, raw="normalize" in kw)
    uv = (u, v) if kw.get("with_stats") else ()
    jfn = jax_eval.make_inference_fn(jm, K, **kw)
    want = jfn(params, constants, jax_proto_class(P, K), jnp.asarray(images),
               jnp.asarray(labels), *(jnp.asarray(a) for a in uv))
    pfn = port_eval.make_inference_fn(tm, K, device="cpu", **kw)
    got = pfn(default_proto_class(P, K), images, labels, *uv)

    _assert_counters_close(got, want)
    pred_eq = (got["pred"].numpy() == np.asarray(want["pred"])).mean()
    assert pred_eq >= 1 - TIE_BUDGET / labels.size
    if not kw.get("with_stats"):
        return
    assert (got["nearest_proto"].numpy()
            == np.asarray(want["nearest_proto"])).mean() >= 0.999
    diff = np.abs(got["agree_counts"].numpy().astype(np.int64)
                  - np.asarray(want["agree_counts"]))
    assert diff.sum() <= 2 * TIE_BUDGET
    np.testing.assert_allclose(got["topk_purity"].numpy(),
                               np.asarray(want["topk_purity"]), atol=1e-3)


def test_seg_evaluator_results_match_jax():
    jm, params, constants, tm = jax_pair(seed=22)
    jev = jax_eval.SegEvaluator(jm, K, with_stats=True, stats_upsampled=True,
                                n_random_pixels=16, seed=3)
    pev = port_eval.SegEvaluator(tm, K, with_stats=True, stats_upsampled=True,
                                 n_random_pixels=16, seed=3, device="cpu")
    jacc = JaxAccumulator(P, K, np.asarray(jax_proto_class(P, K)))
    pacc = ProtoStatsAccumulator(P, K, default_proto_class(P, K))
    for seed in (5, 6):
        images, labels, _, _ = _batch(seed)
        jo = jev.update(params, constants, jax_proto_class(P, K), images, labels)
        po = pev.update(default_proto_class(P, K), images, labels)
        jacc.update_counts(np.asarray(jo["agree_counts"]),
                           np.asarray(jo["topk_purity"]))
        pacc.update_counts(po["agree_counts"], po["topk_purity"])
    want, got = jev.results(), pev.results()
    assert abs(pev.total - jev.total) == 0
    # per class |I/U − I'/U'| ≤ (|ΔI| + |ΔU|) / min(U, U'): 0 (so 1e-6)
    # when the counters are equal, else what the tied pixels can move
    present = jev.union > 0
    assert np.array_equal(pev.union > 0, present)
    d_i = np.abs(pev.intersection - jev.intersection)[present]
    d_u = np.abs(pev.union - jev.union)[present]
    assert d_i.sum() <= TIE_BUDGET and d_u.sum() <= 2 * TIE_BUDGET
    bound = 100.0 * np.mean((d_i + d_u) / np.minimum(pev.union, jev.union)[present])
    assert abs(got["mean_iou"] - want["mean_iou"]) <= bound + 1e-6
    assert got["pixel_accuracy"] == pytest.approx(want["pixel_accuracy"],
                                                  abs=100.0 * TIE_BUDGET / pev.total)
    assert np.abs(pacc.results()["nearest_proto_counts"]
                  - jacc.results()["nearest_proto_counts"]).sum() <= 4 * TIE_BUDGET
    np.testing.assert_allclose(pacc.results()["mean_top_k_purity"],
                               jacc.results()["mean_top_k_purity"], atol=1e-3)


def test_overlay_fn_matches_jax():
    jm, params, constants, tm = jax_pair(seed=23)
    images, _, _, _ = _batch(7, B=1, H=41, W=57)
    jpred, jnear = jax_eval.make_overlay_fn(jm)(params, constants,
                                                jnp.asarray(images))
    ppred, pnear = port_eval.make_overlay_fn(tm, device="cpu")(images)
    assert (ppred.numpy() == np.asarray(jpred)).mean() >= 0.999
    assert (pnear.numpy() == np.asarray(jnear)).mean() >= 0.999


def test_stat_helpers_match_jax():
    rng = np.random.RandomState(9)
    nearest = rng.randint(0, P, (2, 7, 9)).astype(np.int32)
    stat_pred = rng.randint(-1, K, (2, 7, 9)).astype(np.int32)
    pc = default_proto_class(P, K)
    got = port_eval.agreement_counts(torch.from_numpy(nearest),
                                     torch.from_numpy(stat_pred), pc)
    want = jax_eval.agreement_counts(jnp.asarray(nearest), jnp.asarray(stat_pred),
                                     jax_proto_class(P, K), chunk=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    dist = rng.rand(2, 7, 9, P).astype(np.float32)
    rows = rng.randint(0, 33, (2, 10))
    cols = rng.randint(0, 41, (2, 10))
    g = port_eval._bilinear_gather(torch.from_numpy(dist), torch.from_numpy(rows),
                                   torch.from_numpy(cols), 33, 41)
    w = jax_eval._bilinear_gather(jnp.asarray(dist), jnp.asarray(rows),
                                  jnp.asarray(cols), 33, 41)
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    sample_pred = rng.randint(0, K, (2, 10))
    dist_ties = np.round(g.numpy(), 1)  # ties exercise the stable sort
    got_p = port_eval._topk_purity(torch.from_numpy(dist_ties),
                                   torch.from_numpy(sample_pred), pc)
    want_p = jax_eval._topk_purity(jnp.asarray(dist_ties), jnp.asarray(sample_pred),
                                   jax_proto_class(P, K))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4)

    from adlm_tpu.interpret.stats import prototype_pair_distances as jax_pairs
    protos = rng.rand(P, 5).astype(np.float32)
    a = prototype_pair_distances(torch.from_numpy(protos), pc)
    b = jax_pairs(protos, np.asarray(jax_proto_class(P, K)))
    np.testing.assert_allclose(a["same_class_distances"],
                               b["same_class_distances"], rtol=1e-6)


def test_accumulator_map_update_equals_count_update():
    rng = np.random.RandomState(10)
    pc = default_proto_class(P, K)
    nearest = rng.randint(0, P, (2, 7, 9))
    pred = rng.randint(0, K, (2, 7, 9))
    a = ProtoStatsAccumulator(P, K, pc)
    b = ProtoStatsAccumulator(P, K, pc)
    purity = rng.rand(2, P)
    a.update(pred, nearest, topk_purity=purity)
    counts = port_eval.agreement_counts(torch.from_numpy(nearest),
                                        torch.from_numpy(pred), pc)
    b.update_counts(counts, purity)
    np.testing.assert_array_equal(a.results()["nearest_proto_counts"],
                                  b.results()["nearest_proto_counts"])
    jacc = JaxAccumulator(P, K, pc.numpy(), n_random_pixels=5, seed=1)
    pacc = ProtoStatsAccumulator(P, K, pc, n_random_pixels=5, seed=1)
    dist = rng.rand(2, 7, 9, P).astype(np.float32)
    jacc.update(pred, nearest, distances=dist)
    pacc.update(torch.from_numpy(pred), torch.from_numpy(nearest),
                distances=torch.from_numpy(dist))
    for k in ("nearest_proto_counts", "mean_top_k_purity"):
        np.testing.assert_allclose(pacc.results()[k], jacc.results()[k])
