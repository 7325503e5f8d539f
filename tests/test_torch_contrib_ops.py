"""The contrib detection ops of the port against the JAX package on the
CPU, case for case as ``tests/test_contrib_ops.py`` holds the JAX package,
and the plain NMS sweep (what ``csrc/nms_sweep.cu`` must equal on the
card) against the JAX package's loop on a few hundred boxes.

Tolerances: integer, mask, order and kept-row results exact; floats within
1e-6 relative (a 1e-6 floor) in f32; gradients within 1e-5 relative
(deformable convolution's einsum sums in another order: 1e-4).
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu import autograd as jag, np as jnp_, npx as jnpx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd as tag, np as tnp, npx as tnpx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib


@pytest.fixture(autouse=True)
def on_cpu():
    """The CPU device, and one torch thread: these tensors are tiny, and
    the suite runs in parallel workers that share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mx.cpu():
            yield
    finally:
        torch.set_num_threads(threads)


def close(got, want, tol=1e-6, floor=1e-6):
    got, want = onp.asarray(got, onp.float64), onp.asarray(want, onp.float64)
    assert got.shape == want.shape
    assert onp.all(onp.abs(got - want) <= tol * onp.maximum(onp.abs(want), floor) + floor)


def both(fn, *arrays, **kw):
    """``fn`` of each package's npx on the same host arrays; numpy out."""
    j = getattr(jnpx, fn)(*[jnp_.array(a) for a in arrays], **kw)
    t = getattr(tnpx, fn)(*[tnp.array(a) for a in arrays], **kw)

    def host(x):
        return [o.asnumpy() for o in x] if isinstance(x, (tuple, list)) else x.asnumpy()
    return host(j), host(t)


def test_box_iou_known_values():
    a = onp.array([[0, 0, 2, 2], [0, 0, 1, 1]], "float32")
    b = onp.array([[1, 1, 3, 3], [0, 0, 2, 2]], "float32")
    j, t = both("box_iou", a, b)
    assert t.dtype == j.dtype
    close(t, j)
    onp.testing.assert_allclose(t, [[1 / 7, 1.0], [0.0, 0.25]], rtol=1e-6)


def test_box_iou_center_format():
    j, t = both("box_iou", onp.array([[1, 1, 2, 2]], "float32"),
                onp.array([[2, 1, 2, 2]], "float32"), format="center")
    close(t, j)


DATA = onp.array([[0, 0.9, 0.0, 0.0, 2.0, 2.0],
                  [0, 0.8, 0.1, 0.1, 2.0, 2.0],
                  [1, 0.7, 0.0, 0.0, 2.0, 2.0],
                  [0, 0.0, 5.0, 5.0, 6.0, 6.0]], "float32")


@pytest.mark.parametrize("force", [False, True])
def test_box_nms_suppression_and_classes(force):
    kw = dict(overlap_thresh=0.5, valid_thresh=0.1, coord_start=2, score_index=1, id_index=0,
              force_suppress=force)
    j, t = both("box_nms", DATA, **kw)
    assert t.tobytes() == j.tobytes()
    assert (t[1] == -1).all() and (t[3] == -1).all() and (t[2] == -1).all() == force


def _boxes(rng, n, classes=3, spread=1.0):
    xy = rng.rand(n, 2).astype("float32") * spread
    wh = rng.uniform(0.05, 0.5, (n, 2)).astype("float32")
    score = rng.rand(n, 1).astype("float32")
    cls = rng.randint(0, classes, (n, 1)).astype("float32")
    return onp.concatenate([cls, score, xy, xy + wh], 1)


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.5, valid_thresh=0.05, id_index=0),
    dict(overlap_thresh=0.3, valid_thresh=0.0, topk=100, id_index=0, force_suppress=True),
    dict(overlap_thresh=0.45, valid_thresh=0.2, id_index=-1),
], ids=["by_class", "topk_forced", "no_ids"])
def test_box_nms_few_hundred_boxes(kw):
    """The sweep over 300 boxes, rows and order bit for bit as JAX's."""
    rng = onp.random.RandomState(1)
    data = _boxes(rng, 300)
    data[::7, 1] = data[3, 1]          # ties in score
    j, t = both("box_nms", data, **kw)
    assert t.tobytes() == j.tobytes()
    assert (t[:, 0] >= 0).sum() > 10


@pytest.mark.parametrize("case", ["random", "all_overlapping", "all_disjoint", "ties"])
def test_plain_sweep_equals_jax_loop(case):
    """nms_sweep_plain over nms_decisions against the JAX package's
    box_nms (its fori_loop) on adversarial sets."""
    rng = onp.random.RandomState(2)
    n = 200                            # not a multiple of 32 or 64
    data = _boxes(rng, n, classes=2)
    if case == "all_overlapping":
        data[:, 2:] = [0.0, 0.0, 1.0, 1.0]
        data[:, 2:] += rng.rand(n, 4).astype("float32") * 0.01
    elif case == "all_disjoint":
        data[:, 2] = onp.arange(n) * 2.0
        data[:, 4] = data[:, 2] + 1.0
    elif case == "ties":
        data[:, 1] = onp.round(data[:, 1] * 4) / 4
    want = jnpx.box_nms(jnp_.array(data), overlap_thresh=0.4, valid_thresh=0.1,
                        id_index=0).asnumpy()
    x = torch.from_numpy(data)
    order = torch.argsort(-x[:, 1], stable=True)
    xs = x[order]
    dec = contrib.nms_decisions(xs[None, :, 2:6], 0.4, xs[None, :, 0])
    keep = contrib.nms_sweep(dec, (xs[:, 1] > 0.1)[None])
    assert keep.dtype == torch.bool and keep.shape == (1, n)
    assert (keep[0].numpy() == (want[:, 0] != -1)).all()
    got = torch.where(keep[0][:, None], xs, -torch.ones_like(xs)).numpy()
    assert got.tobytes() == want.tobytes()


def test_nms_sweep_checks_its_inputs():
    with pytest.raises(MXNetError):
        contrib.nms_sweep(torch.zeros(2, 3, 4, dtype=torch.bool),
                          torch.zeros(2, 3, dtype=torch.bool))


def _feat(shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _grad_pair(fn_name, arrays, grad_idx, kw, tol=1e-5):
    """Outputs and the gradients of sum(out * w) for the inputs
    ``grad_idx`` (an index or a tuple of them), each package."""
    idx = (grad_idx,) if isinstance(grad_idx, int) else grad_idx
    out = []
    for np, npx, ag in ((jnp_, jnpx, jag), (tnp, tnpx, tag)):
        xs = [np.array(a) for a in arrays]
        for i in idx:
            xs[i].attach_grad()
        with ag.record():
            y = getattr(npx, fn_name)(*xs, **kw)
            w = np.array(onp.linspace(-1, 1, y.size).astype("float32").reshape(y.shape))
            (y * w).sum().backward()
        out.append((y.asnumpy(), [xs[i].grad.asnumpy() for i in idx]))
    (jy, jg), (ty, tg) = out
    close(ty, jy)
    for a, b in zip(tg, jg):
        assert onp.linalg.norm(a - b) <= tol * max(onp.linalg.norm(b), 1e-6)
    return ty, tg[0]


def test_roi_align_values_and_grad():
    feat = onp.arange(16, dtype="float32").reshape(1, 1, 4, 4)
    rois = onp.array([[0, 0, 0, 3, 3]], "float32")
    y, g = _grad_pair("roi_align", [feat, rois], 0, dict(pooled_size=(2, 2), spatial_scale=1.0))
    onp.testing.assert_allclose(y[0, 0], [[3.75, 5.25], [9.75, 11.25]], rtol=1e-6)
    j, t = both("roi_align", feat, rois, pooled_size=(2, 2), spatial_scale=1.0, aligned=True)
    close(t, j)


@pytest.mark.parametrize("kw", [dict(pooled_size=(2, 3), sample_ratio=3, spatial_scale=0.5,
                                     aligned=True)])
def test_roi_align_batch(kw):
    """RoIs over two images, partly outside the map (forward; the
    gradient is held in the case above and on the card)."""
    rng = onp.random.RandomState(0)
    feat = _feat((2, 3, 8, 8))
    rois = onp.concatenate([rng.randint(0, 2, (12, 1)),
                            rng.uniform(-2, 4, (12, 2)), rng.uniform(4, 10, (12, 2))],
                           1).astype("float32")
    j, t = both("roi_align", feat, rois, **kw)
    close(t, j)


def test_roi_align_position_sensitive_raises():
    with pytest.raises(MXNetError):
        tnpx.roi_align(tnp.array(_feat((1, 1, 4, 4))), tnp.array([[0, 0, 0, 3, 3.0]]), (2, 2),
                       position_sensitive=True)


def test_roi_pooling_max_semantics():
    feat = onp.arange(16, dtype="float32").reshape(1, 1, 4, 4)
    j, t = both("roi_pooling", feat, onp.array([[0, 0, 0, 3, 3]], "float32"),
                pooled_size=(2, 2), spatial_scale=1.0)
    assert t.tobytes() == j.tobytes()
    rng = onp.random.RandomState(3)
    rois = onp.concatenate([rng.randint(0, 2, (12, 1)), rng.uniform(0, 5, (12, 2)),
                            rng.uniform(5, 16, (12, 2))], 1).astype("float32")
    j, t = both("roi_pooling", _feat((2, 3, 8, 8)), rois, pooled_size=(3, 2), spatial_scale=0.5)
    assert t.tobytes() == j.tobytes()


@pytest.mark.parametrize("kw", [dict(threshold=0.5), dict(threshold=0.3, topk=2),
                                dict(threshold=0.6, is_ascend=True)])
def test_bipartite_matching(kw):
    scores = onp.array([[0.9, 0.2, 0.1], [0.85, 0.8, 0.1]], "float32")
    j, t = both("bipartite_matching", scores, **kw)
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    rng = onp.random.RandomState(4)
    j, t = both("bipartite_matching", rng.rand(7, 5).astype("float32"), **kw)
    for a, b in zip(j, t):
        assert a.tolist() == b.tolist()


def _targets(anchors, labels, **kw):
    cls_preds = onp.zeros((labels.shape[0], 4, anchors.shape[1]), "float32")
    j, t = both("multibox_target", anchors, labels, cls_preds, **kw)
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and a.shape == b.shape
    assert t[2].tobytes() == j[2].tobytes() and t[1].tobytes() == j[1].tobytes()
    close(t[0], j[0])
    return t


def test_multibox_target_matching():
    anchors = onp.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                          [0.0, 0.5, 0.5, 1.0]]], "float32")
    labels = onp.array([[[2.0, 0.0, 0.0, 0.5, 0.5], [-1.0, -1, -1, -1, -1]]], "float32")
    loc_t, loc_m, cls_t = _targets(anchors, labels)
    assert cls_t[0].tolist() == [3.0, 0.0, 0.0]
    assert loc_m[0].tolist() == [1, 1, 1, 1] + [0] * 8


def test_multibox_target_forces_best_anchor():
    """JAX's case, padded to the shapes of the case above (a third anchor
    far away, a padded label row) so both packages reuse its kernels."""
    anchors = onp.array([[[0.0, 0.0, 0.4, 0.4], [0.6, 0.6, 1.0, 1.0],
                          [0.9, 0.0, 1.0, 0.1]]], "float32")
    labels = onp.array([[[0.0, 0.05, 0.05, 0.25, 0.25], [-1.0, -1, -1, -1, -1]]], "float32")
    _, _, cls_t = _targets(anchors, labels, overlap_threshold=0.9)
    assert cls_t[0].tolist() == [1.0, 0.0, 0.0]


def _anchors(rng, A):
    c = rng.rand(A, 2).astype("float32")
    s = rng.uniform(0.05, 0.4, (A, 2)).astype("float32")
    return onp.concatenate([c - s / 2, c + s / 2], 1)[None]


def test_multibox_target_batch_and_shared_claims():
    """A batch of 3 over 120 anchors, padded rows, and two gts that claim
    the same anchor (the last one wins, as the JAX scatter writes)."""
    rng = onp.random.RandomState(5)
    anchors = _anchors(rng, 120)
    labels = -onp.ones((3, 6, 5), "float32")
    for b, m in enumerate((6, 3, 1)):
        box = rng.rand(m, 2).astype("float32") * 0.6
        labels[b, :m, 0] = rng.randint(0, 20, m)
        labels[b, :m, 1:3] = box
        labels[b, :m, 3:5] = box + rng.uniform(0.1, 0.4, (m, 2))
    labels[0, 1, 1:] = labels[0, 0, 1:]          # a duplicate gt box
    _targets(anchors, labels, overlap_threshold=0.4)


def test_multibox_detection_roundtrip():
    """JAX's case, padded to the matching case's shapes (a far anchor
    scored background, a padded label row)."""
    anchors = onp.array([[[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9],
                          [0.9, 0.0, 1.0, 0.1]]], "float32")
    gt = onp.array([0.15, 0.12, 0.52, 0.48], "float32")
    labels = onp.array([[[1.0, *gt], [-1.0, -1, -1, -1, -1]]], "float32")
    loc_t, _, _ = _targets(anchors, labels)
    probs = onp.zeros((1, 3, 3), "float32")
    probs[0, 2, 0] = 0.9
    probs[0, 0, 1] = 1.0
    probs[0, 0, 2] = 1.0
    j, t = both("multibox_detection", probs, loc_t, anchors, clip=False)
    close(t, j)
    det = t[0][t[0][:, 0] >= 0]
    assert det.shape[0] == 1 and det[0, 0] == 1.0


def test_multibox_detection_batch():
    """B 3, 6 classes, 250 anchors: kept rows and order exact, floats 1e-6."""
    rng = onp.random.RandomState(6)
    A = 250
    anchors = _anchors(rng, A)
    logits = rng.randn(3, 6, A).astype("float32") * 2
    probs = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(3, A * 4) * 0.5).astype("float32")
    j, t = both("multibox_detection", probs, loc, anchors, threshold=0.01, nms_threshold=0.45,
                nms_topk=40)
    assert ((t[..., 0] == -1) == (j[..., 0] == -1)).all()
    assert t[..., :2].tobytes() == j[..., :2].tobytes()
    close(t, j)
    assert (t[..., 0] >= 0).sum() > 10


def test_npx_long_tail():
    x, y = tnp.array(onp.ones((2, 1), "float32")), tnp.array(onp.ones((2, 5), "float32"))
    assert tnpx.broadcast_like(x, y).shape == (2, 5)
    mx.random.seed(0)
    assert tnpx.uniform_n(0.0, 1.0, batch_shape=(3, 2)).shape == (3, 2)
    assert tnpx.normal_n(onp.zeros(4, "float32"), 1.0, batch_shape=(2,)).shape == (2, 4)
    assert tnpx.bernoulli(prob=0.5, size=(6,)).shape == (6,)


def _deform(kw, shapes, seed):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*s).astype("float32") * (0.3 if i == 1 else 1.0)
            for i, s in enumerate(shapes)], kw


def test_deformable_convolution_zero_offsets_match_conv():
    rs = onp.random.RandomState(0)
    B, C, H, W, O, K = 2, 4, 8, 8, 6, 3
    x, w, b = (rs.randn(B, C, H, W).astype("float32"), rs.randn(O, C, K, K).astype("float32"),
               rs.randn(O).astype("float32"))
    off = onp.zeros((B, 2 * K * K, H, W), "float32")
    j, t = both("deformable_convolution", x, off, w, b, kernel=(K, K), pad=(1, 1))
    close(t, j, 1e-5, 1e-5)
    ref = tnpx.convolution(tnp.array(x), tnp.array(w), tnp.array(b), kernel=(K, K), pad=(1, 1),
                           num_filter=O).asnumpy()
    onp.testing.assert_allclose(t, ref, rtol=1e-4, atol=1e-4)


def test_deformable_convolution_integer_shift():
    rs = onp.random.RandomState(1)
    x = onp.zeros((1, 2, 6, 6), "float32")
    x[:, :, 2:4, 2:4] = rs.rand(1, 2, 2, 2)
    w = onp.zeros((1, 2, 1, 1), "float32")
    w[0, :, 0, 0] = 1.0
    off = onp.ones((1, 2, 6, 6), "float32")
    j, t = both("deformable_convolution", x, off, w, kernel=(1, 1), no_bias=True)
    close(t, j)


@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), dilate=(2, 2), num_deformable_group=2,
         no_bias=True)], ids=["strided_groups"])
def test_deformable_convolution_grads(kw):
    rs = onp.random.RandomState(2)
    G = kw.get("num_deformable_group", 1)
    s, d = kw.get("stride", (1, 1))[0], kw.get("dilate", (1, 1))[0]
    OH = (7 + 2 - d * 2 - 1) // s + 1
    x = rs.randn(2, 4, 7, 7).astype("float32")
    off = (0.7 * rs.randn(2, 2 * G * 9, OH, OH)).astype("float32")
    w = rs.randn(3, 4, 3, 3).astype("float32")
    _grad_pair("deformable_convolution", [x, off, w], (0, 1, 2), kw, tol=1e-4)


def test_deformable_convolution_shape_checks():
    with pytest.raises(MXNetError):
        tnpx.deformable_convolution(tnp.array(onp.zeros((1, 2, 4, 4), "float32")),
                                    tnp.array(onp.zeros((1, 3, 4, 4), "float32")),
                                    tnp.array(onp.zeros((1, 2, 3, 3), "float32")),
                                    kernel=(3, 3), pad=(1, 1))
