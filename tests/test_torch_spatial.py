"""PyTorch port, spatial eval in one process: the row plan and the row
exchange of ``adlm_tpu_torch.parallel.spatial`` / ``core.mesh``, and the
row windows of the resize and of upsample-argmin's plain version.

* For M = 1..8 ranks and the layer geometry of the flagship (DeepLabV2-
  ResNet101 on 1024 rows) and of the tiny test model (one block per
  layer, on 64 and 65 rows), as ``forward_rows`` fetches it (recorded
  from a forward on a narrow frame): every operator that exchanges
  rows, the logits' resize and the upsampled statistics' kernel window
  take exactly the rows their outputs read, each row from the rank that
  owns it or the fill past the image edge; the exchange itself, M ranks
  simulated by threads whose SUM is a barrier, returns each rank the
  global rows it asked for (zeros or −inf past the edge).  The 8 ranks
  at ASPP's rate 24 fetch from ranks beyond their neighbours.
* ``resize_bilinear_rows`` and ``upsampled_argmin_reference`` on row
  windows of a slab equal the same rows of their whole-frame result bit
  for bit; the resize's whole frame is ``resize_bilinear``'s.
* MSC models and the tensor-parallel head still raise naming ROADMAP
  item 9b; a slab that lacks a row its window reads raises.

The spatial eval against the JAX package's spatially sharded eval runs
in tests/test_torch_parallel.py's 2-rank world.
"""

import threading

import numpy as np
import pytest
import torch

from adlm_tpu_torch.core import mesh as mesh_mod
from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.core.mesh import Mesh, row_range, row_sources
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.ops.resize import (
    bilinear_source_rows,
    resize_bilinear,
    resize_bilinear_rows,
)
from adlm_tpu_torch.ops.upsample_argmin import (
    _src_coords,
    tap_rows,
    upsampled_argmin_reference,
    upsampled_nearest,
)
from adlm_tpu_torch.parallel.spatial import (
    Rank,
    forward_rows,
    make_spatial_inference_fn,
    row_plan,
)

TINY = dict(num_prototypes=12, num_classes=4, prototype_channels=16,
            deeplab_n_features=16, deeplab_n_blocks=(1, 1, 1, 1))


def _model(flagship: bool) -> PPNet:
    cfg = PPNetConfig() if flagship else PPNetConfig(**TINY)
    return PPNet(cfg, generator=torch.Generator().manual_seed(0))


class _Recorder(Rank):
    """A world of one that records every fetch ``forward_rows`` makes:
    (geometry, input rows, output rows, fill)."""

    def __init__(self):
        super().__init__(Mesh(1, 1, 0, torch.device("cpu")))
        self.ops = []

    def fetch(self, x, n_in, op, n_out, fill=0.0):
        self.ops.append((op, n_in, n_out, fill))
        return super().fetch(x, n_in, op, n_out, fill)


@pytest.fixture(scope="module")
def geometries():
    """(the fetches of a forward, input rows, grid rows) per case, on
    frames 8 pixels wide; the grid rows also from the whole-frame forward."""
    out = {}
    for name, flagship, n in (("flagship", True, 1024), ("tiny64", False, 64),
                              ("tiny65", False, 65)):
        model = _model(flagship).eval()
        rec = _Recorder()
        x = torch.zeros(1, 3, n, 8)
        with torch.no_grad():
            _, _, grid = forward_rows(model, x, rec, False)
            assert grid == model.conv_features(x).shape[2]
        out[name] = (rec.ops, n, grid)
    assert out["flagship"][2] == 129
    return out


class _ThreadWorld:
    """M ranks as threads: ``core.mesh._reduce`` becomes a SUM across the
    threads' tensors behind a barrier."""

    def __init__(self, M: int):
        self.M = M
        self.barrier = threading.Barrier(M)
        self.slots = [None] * M
        self.ranks = {}

    def reduce(self, t, op, group):
        r = self.ranks[threading.get_ident()]
        self.slots[r] = t
        self.barrier.wait()
        total = sum(s.clone() for s in self.slots)
        self.barrier.wait()
        t.copy_(total)
        self.barrier.wait()

    def run(self, fn):
        out, errs = [None] * self.M, []

        def body(r):
            self.ranks[threading.get_ident()] = r
            try:
                out[r] = fn(Mesh(1, self.M, r, torch.device("cpu"), backend="threads",
                                 model_group=None))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.M)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def _check_sources(owned, need, n):
    """``row_sources`` covers ``need`` once, in order, each row from its
    owner or (past the edge) the fill."""
    pieces = row_sources(owned, need)
    pos = need[0]
    for lo, hi, src in pieces:
        assert lo == pos and hi > lo, pieces
        if src == -1:
            assert hi <= 0 or lo >= n, pieces
        else:
            assert owned[src][0] <= lo and hi <= owned[src][1], (pieces, owned)
        pos = hi
    assert pos == need[1], pieces


@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("geom", ["flagship", "tiny64", "tiny65"])
def test_row_plan_covers_every_tap_and_the_exchange_moves_them(geometries, geom, M,
                                                                monkeypatch):
    ops, label, grid = geometries[geom]
    world = _ThreadWorld(M)
    monkeypatch.setattr(mesh_mod, "_reduce", world.reduce)
    for op, n, n_out, fill in ops:
        name = f"{op} {n} -> {n_out}"
        owned, outs = row_plan(n, M), row_plan(n_out, M)
        need = [op.reads(r) for r in outs]
        for q in range(M):
            _check_sources(owned, need[q], n)
            lo, hi = outs[q]
            # each output row's taps lie in the fetched rows, and a conv
            # with no H padding over them gives exactly the rank's rows
            taps = [o * op.stride - op.padding + j * op.dilation
                    for o in (lo, hi - 1) for j in (0, op.kernel - 1)]
            assert need[q][0] <= min(taps) and max(taps) < need[q][1], name
            flat = type(op)(op.kernel, op.stride, 0, op.dilation, op.ceil)
            assert flat.out_rows(need[q][1] - need[q][0]) == hi - lo, (name, q)
        full = torch.arange(n, dtype=torch.float32)[None, :, None, None].expand(1, n, 3, 2)

        def fetch(mesh, owned=owned, need=need, full=full, n=n, fill=fill):
            a, b = owned[mesh.model_index]
            return mesh.exchange_rows(full[:, a:b].contiguous(), 1, owned, need, fill)

        got = world.run(fetch)
        for q in range(M):
            lo, hi = need[q]
            rows = torch.arange(lo, hi, dtype=torch.float32)
            want = torch.where((rows >= 0) & (rows < n), rows, torch.tensor(fill))
            assert torch.equal(got[q][0, :, 0, 0], want), (name, q)
    # the logits' resize and the kernel's window over each rank's label rows
    # (the resize's rows: the taps and a row of margin each way)
    t0, t1 = (t.long() for t in _src_coords(label, grid, "cpu")[:2])
    for q, (lo, hi) in enumerate(row_plan(label, M)):
        first, last = tap_rows(label, grid, lo, hi)
        _check_sources(row_plan(grid, M), (first, last), grid)
        assert first == int(t0[lo:hi].min()) and last == int(t1[lo:hi].max()) + 1, q
        wide = bilinear_source_rows(label, grid, lo, hi)
        _check_sources(row_plan(grid, M), wide, grid)
        assert wide == (max(first - 1, 0), min(last + 1, grid)), q


@pytest.mark.parametrize("shape", [(9, 9, 64, 64), (33, 65, 257, 513), (129, 257, 1024, 2048),
                                   (65, 97, 33, 47)], ids=str)
def test_resize_rows_equal_the_whole_frame_rows(shape):
    h, w, H, W = shape
    x = torch.from_numpy(np.random.RandomState(0).randn(2, h, w, 5).astype(np.float32))
    whole = resize_bilinear(x, (H, W))
    assert torch.equal(resize_bilinear_rows(x, (H, W), 0, H), whole)
    for m in (2, 3):
        for lo, hi in row_plan(H, m) + [(H // 3 + 1, H // 3 + 2)]:
            first, last = bilinear_source_rows(H, h, lo, hi)
            got = resize_bilinear_rows(x[:, first:last], (H, W), lo, hi, first_row=first, in_h=h)
            assert torch.equal(got, whole[:, lo:hi]), (lo, hi)
    first, last = bilinear_source_rows(H, h, H // 2, H)
    with pytest.raises(ValueError):
        resize_bilinear_rows(x[:, first + 1:last], (H, W), H // 2, H, first_row=first + 1,
                             in_h=h)


@pytest.mark.parametrize("shape", [(9, 9, 12, 64, 64), (33, 65, 70, 257, 513),
                                   (65, 97, 19, 33, 47), (16, 32, 19, 128, 256)], ids=str)
def test_upsample_argmin_rows_equal_the_whole_frame_rows(shape):
    h, w, P, H, W = shape
    rng = np.random.RandomState(1)
    d = torch.from_numpy(rng.rand(2, h, w, P).astype(np.float32))
    ties = torch.from_numpy(rng.randint(0, 3, (2, h, w, P)).astype(np.float32))
    for dist in (d, ties):
        whole = upsampled_argmin_reference(dist, (H, W), exact=True)
        assert torch.equal(upsampled_nearest(dist, (H, W)), whole)
        for m in (2, 3):
            for lo, hi in row_plan(H, m):
                first, last = tap_rows(H, h, lo, hi)
                slab = dist[:, first:last]
                win = dict(out_rows=(lo, hi - lo), map_rows=(first, h))
                assert torch.equal(upsampled_argmin_reference(slab, (H, W), exact=True, **win),
                                   whole[:, lo:hi])
                assert torch.equal(upsampled_nearest(slab, (H, W), **win), whole[:, lo:hi])
    first, last = tap_rows(H, h, 0, H // 2)
    with pytest.raises(ValueError):
        upsampled_argmin_reference(d[:, first:last - 1], (H, W), out_rows=(0, H // 2),
                                   map_rows=(first, h))


def test_msc_and_the_tensor_parallel_head_still_raise_naming_item_9b():
    from adlm_tpu_torch.parallel.sharding import make_sharded_inference_fn

    mesh = Mesh(1, 2, 0, torch.device("cpu"))
    msc = PPNet(PPNetConfig(**TINY, msc_scales=(0.5, 0.75)))
    with pytest.raises(NotImplementedError, match="9b"):
        make_spatial_inference_fn(msc, 4, mesh)
    with pytest.raises(NotImplementedError, match="9b"):
        make_sharded_inference_fn(_model(False), 4, mesh, prototype_parallel=True)
    assert row_range(1, 9, 2) == (4, 9)
    with pytest.raises(ValueError):
        row_plan(7, 8)                              # a rank would hold no row
