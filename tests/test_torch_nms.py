"""The port's plain batched NMS (lang2seg_tpu_torch.ops.nms.nms_padded,
the CPU path and the oracle of the CUDA kernel) against the JAX
package's `nms_padded` and its Pallas kernel `nms_pallas_batched` (run in
interpret mode, as tests/test_nms_pallas.py does): bit-identical
(keep_idx, keep_mask) on the draws of tests/test_nms.py and
tests/test_nms_pallas.py, plus an IoU that lies between f32(0.7) and the
double 0.7."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lang2seg_tpu.ops.nms import nms_padded as jnms_padded
from lang2seg_tpu.ops.nms_pallas import nms_pallas_batched
from lang2seg_tpu_torch.ops import nms_cuda
from lang2seg_tpu_torch.ops.nms import nms_padded
from lang2seg_tpu_torch.tools.profile_nms import edge_cases
from lang2seg_tpu_torch.utils import trace
from tests.test_nms import greedy_nms_oracle, rand_boxes


def _port(boxes, valid, thresh, max_out):
    ki, km = nms_padded(torch.from_numpy(boxes), torch.from_numpy(valid),
                        thresh, max_out)
    return ki.numpy(), km.numpy()


def _compare(boxes, valid, thresh, max_out, pallas=False, block=256):
    """Port == JAX nms_padded per lane, full wire format (padded idx 0);
    with `pallas`, also == nms_pallas_batched in tiles of `block`."""
    ki, km = _port(boxes, valid, thresh, max_out)
    assert ki.dtype == np.int32 and km.dtype == np.bool_
    assert ki.shape == km.shape == (boxes.shape[0], max_out)
    for lane in range(boxes.shape[0]):
        ri, rm = jnms_padded(jnp.asarray(boxes[lane]),
                             jnp.asarray(valid[lane]), thresh, max_out)
        np.testing.assert_array_equal(km[lane], np.asarray(rm))
        np.testing.assert_array_equal(ki[lane], np.asarray(ri))
    if pallas:
        pi, pm = nms_pallas_batched(jnp.asarray(boxes), jnp.asarray(valid),
                                    thresh, max_out, block=block, chunk=64,
                                    interpret=True)
        np.testing.assert_array_equal(km, np.asarray(pm))
        np.testing.assert_array_equal(ki, np.asarray(pi))
    return ki, km


def test_matches_sequential_oracle(rng):
    boxes = np.stack([rand_boxes(rng, 400) for _ in range(3)])
    ki, km = _compare(boxes, np.ones((3, 400), bool), 0.7, 400)
    for lane in range(3):
        np.testing.assert_array_equal(ki[lane][km[lane]],
                                      greedy_nms_oracle(boxes[lane], 0.7))


def test_random_draw_matches_pallas(rng):
    boxes = np.stack([rand_boxes(rng, 512) for _ in range(3)])
    _compare(boxes, np.ones((3, 512), bool), 0.7, 256, pallas=True)


def test_dense_cluster(rng):
    base = np.array([10.0, 10.0, 60.0, 60.0])
    boxes = (base[None, None, :]
             + rng.uniform(-8, 8, (2, 512, 4))).astype(np.float32)
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 1)
    _compare(boxes, np.ones((2, 512), bool), 0.5, 256, pallas=True)


def test_validity_and_truncation(rng):
    boxes = np.stack([rand_boxes(rng, 512) for _ in range(2)])
    valid = np.zeros((2, 512), bool)
    valid[:, :100] = True
    valid[1, 7] = False
    _compare(boxes, valid, 0.7, 64, pallas=True)
    # a high threshold keeps nearly everything: max_out binds mid-way
    ki, km = _compare(boxes, np.ones((2, 512), bool), 0.99, 48, pallas=True)
    assert km.all()


def test_spread_grid_and_twins(rng):
    """tests/test_nms_pallas.py::test_pallas_nms_multichunk_frontier: a
    spread grid keeps more than max_out; jittered twins are suppressed by
    partners anywhere in the kept list."""
    xs, ys = np.meshgrid(np.arange(32) * 20.0, np.arange(16) * 20.0)
    grid = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 12,
                     ys.ravel() + 12], 1)[None].astype(np.float32)
    _compare(grid, np.ones((1, 512), bool), 0.5, 256, pallas=True)
    twins = grid + rng.uniform(-2, 2, grid.shape).astype(np.float32)
    inter = np.empty((1, 1024, 4), np.float32)
    inter[:, 0::2] = grid
    inter[:, 1::2] = twins
    _compare(inter, np.ones((1, 1024), bool), 0.5, 256, pallas=True)


# the CUDA kernel's edge cases (chip_smoke.py phase 3) up to 500 boxes
EDGE = [c for c in edge_cases() if c[1].shape[1] <= 500]


@pytest.mark.parametrize("case", EDGE, ids=[c[0] for c in EDGE])
def test_kernel_edge_cases(case):
    """Tile edges (N = 63, 64, 65, 129), max_out reached on a tile's last
    box and mid-tile, max_out > N, an all-invalid lane beside valid ones,
    1, 4 and 8 lanes: the port's plain version against JAX nms_padded and
    the Pallas kernel in tiles of 64, the CUDA kernel's tile."""
    _, boxes, valid, thresh, max_out = case
    ki, km = _compare(boxes, valid, thresh, max_out, pallas=True, block=64)
    kept = km.sum(1)
    assert (kept <= min(max_out, boxes.shape[1])).all()
    assert not km[~valid.any(1)].any()           # an all-invalid lane


def test_edge_cases_reach_their_edges():
    """Each named edge case does what its name says, on the plain version."""
    cases = {c[0]: c[1:] for c in edge_cases()}

    def kept(name):
        boxes, valid, thresh, max_out = cases[name]
        ki, km = _port(boxes, valid, thresh, max_out)
        return [list(ki[lane][km[lane]]) for lane in range(len(ki))]

    assert kept("max_out_at_tile_end_2x200_64")[0][-1] == 63
    assert kept("max_out_mid_tile_2x200_100")[0][-1] == 99
    assert all(len(k) < 300 for k in kept("max_out_above_n_2x100_300"))
    assert [len(k) for k in kept("invalid_lane_3x300_128")] == [128, 0, 128]
    assert [len(k) for k in kept("grid_frontier_2x2560_2000")] == [2000, 2000]
    assert [cases[f"lanes_{e}x500_128"][0].shape[0] for e in (1, 4, 8)] \
        == [1, 4, 8]


def test_iou_between_f32_and_double_threshold():
    """Nested boxes with inter / union = 3_874_570 / 5_779_207 in f32:
    the f32 IoU rounds to exactly f32(0.7), so `iou > 0.7f` is False and
    the second box is kept; the exact quotient is 0.70000002 > 0.7, so a
    double compare would suppress it."""
    a = [0.0, 0.0, 2406.0, 2400.0]
    b = [0.0, 0.0, 2094.0, 1930.0]
    f = np.float32
    inter = f(2095) * f(1931)
    union = f(2407) * f(2401) + inter - inter
    assert f(inter / union) == f(0.7)
    assert float(inter) / float(union) > 0.7
    boxes = np.asarray([[a, b]], np.float32)
    ki, km = _compare(boxes, np.ones((1, 2), bool), 0.7, 2)
    assert km.all() and list(ki[0]) == [0, 1]


def test_wrapper_takes_plain_path_on_cpu(rng):
    """nms_cuda.nms_batched on CPU tensors is the plain version and does
    not count a kernel launch."""
    boxes = torch.from_numpy(np.stack([rand_boxes(rng, 300)
                                       for _ in range(2)]))
    valid = torch.ones((2, 300), dtype=torch.bool)
    before = trace.counters().get("nms.launches", 0)
    ki, km = nms_cuda.nms_batched(boxes, valid, 0.7, 64)
    ri, rm = nms_padded(boxes, valid, 0.7, 64)
    assert torch.equal(ki, ri) and torch.equal(km, rm)
    assert trace.counters().get("nms.launches", 0) == before


def test_wrapper_rejects_other_devices():
    boxes = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        nms_cuda.nms_batched(boxes, torch.ones((1, 4), dtype=torch.bool,
                                               device="meta"), 0.7, 2)
