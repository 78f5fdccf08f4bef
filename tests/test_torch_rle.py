"""The port's RLE codec (lang2seg_tpu_torch.data.rle) against the NumPy
path of the JAX package's `data/rle.py` (its native library switched
off), bit for bit: area, merge (union and intersection, two and three
RLEs, string / bytes / list counts), iou, fr_poly (maskApi's rasterizer
on random and oracle polygons, and the cv2 path), fr_uncompressed; and
the maskApi rasterizer against the loop oracle of tests/test_ref_exact.py.
The port loads no native library."""

import numpy as np
import pytest

from lang2seg_tpu.data import rle as jrle
from lang2seg_tpu_torch.data import rle
from tests.test_ref_exact import _fr_poly_loop_oracle, _random_polys


@pytest.fixture(autouse=True)
def jax_numpy_path(monkeypatch):
    """The JAX codec's NumPy path, whether or not its native library is
    built."""
    monkeypatch.setattr(jrle, "_lib", None)


def _masks(seed, n, h=37, w=53):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = (0.05, 0.3, 0.7, 0.97)[i % 4]
        m = (rng.rand(h, w) < p).astype(np.uint8)
        m[0, 0] = i % 2                 # both first-pixel states
        out.append(m)
    return out


def _same(a, b):
    assert a["size"] == b["size"]
    assert a["counts"] == b["counts"]


def test_port_loads_no_native_library():
    assert not hasattr(rle, "_lib") and not hasattr(rle, "ctypes")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_area_and_iou_match_jax(seed):
    ms = _masks(seed, 4)
    codes = [rle.encode(m) for m in ms]
    for m, c in zip(ms, codes):
        assert rle.area(c) == jrle.area(c) == int(m.sum())
    for a in codes:
        for b in codes:
            assert rle.iou(a, b) == jrle.iou(a, b)
    assert rle.iou(codes[0], codes[0]) == 1.0
    empty = rle.encode(np.zeros((37, 53), np.uint8))
    assert rle.iou(empty, empty) == jrle.iou(empty, empty) == 0.0


@pytest.mark.parametrize("intersect", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_merge_matches_jax(n, intersect):
    ms = _masks(10 + n, n)
    codes = [rle.encode(m) for m in ms]
    # counts as bytes, as a str and as an uncompressed list
    codes[0] = {"size": codes[0]["size"],
                "counts": codes[0]["counts"].decode("ascii")}
    if n > 1:
        codes[1] = {"size": codes[1]["size"],
                    "counts": rle.str_decode(codes[1]["counts"]).tolist()}
    got, want = rle.merge(codes, intersect), jrle.merge(codes, intersect)
    _same(got, want)
    acc = ms[0]
    for m in ms[1:]:
        acc = (acc & m) if intersect else (acc | m)
    np.testing.assert_array_equal(rle.decode(got), acc)


def test_merge_refuses_nothing():
    with pytest.raises(ValueError):
        rle.merge([])


def test_fr_poly_random_polygons_match_jax():
    """40 random polygons (convex, self-intersecting, fractional boxes)
    bit for bit against the JAX rasterizer and the loop oracle."""
    for xy, h, w in _random_polys(np.random.RandomState(4), 40):
        counts = rle._poly_boundary_counts(xy, h, w)
        np.testing.assert_array_equal(counts, _fr_poly_loop_oracle(xy, h, w))
        _same(rle.fr_poly([list(xy)], h, w), jrle.fr_poly([list(xy)], h, w))


@pytest.mark.parametrize("polys,h,w", [
    ([[10, 10, 30, 10, 30, 25, 10, 25]], 40, 50),       # integer box
    ([[2, 2, 10, 2, 10, 8, 2, 8],
      [20, 12, 28, 12, 28, 18, 20, 18]], 30, 40),       # two parts
    ([[5.5, 5.5, 5.5, 5.5, 20.2, 7.1, 9.9, 18.4]], 25, 25),  # repeated vertex
    ([[-3.0, -2.0, 45.0, 4.0, 20.0, 33.0]], 30, 40),    # beyond the image
    ([[0, 0, 0.4, 0, 0.4, 9, 0, 9]], 12, 12),           # under a pixel wide
])
def test_fr_poly_oracle_cases_match_jax(polys, h, w):
    got = rle.fr_poly(polys, h, w)
    _same(got, jrle.fr_poly(polys, h, w))
    if len(polys) == 1:
        np.testing.assert_array_equal(
            rle.str_decode(got["counts"]),
            _fr_poly_loop_oracle(np.asarray(polys[0], np.float64), h, w))


def test_fr_poly_integer_box_is_the_box():
    m = rle.decode(rle.fr_poly([[10, 10, 30, 10, 30, 25, 10, 25]], 40, 50))
    want = np.zeros((40, 50), np.uint8)
    want[10:25, 10:30] = 1
    np.testing.assert_array_equal(m, want)


def test_fr_poly_cv2_matches_jax():
    for xy, h, w in _random_polys(np.random.RandomState(6), 10):
        _same(rle.fr_poly([list(xy)], h, w, method="cv2"),
              jrle.fr_poly([list(xy)], h, w, method="cv2"))


def test_fr_uncompressed_matches_jax():
    m = _masks(3, 1)[0]
    counts = rle.str_decode(rle.encode(m)["counts"]).tolist()
    obj = {"size": [37, 53], "counts": counts}
    got = rle.fr_uncompressed(obj)
    _same(got, jrle.fr_uncompressed(obj))
    np.testing.assert_array_equal(rle.decode(got), m)
