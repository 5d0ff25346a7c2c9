"""The port's image-space ops against ``monoflex_tpu.ops.image_ops`` on the same
numpy inputs (JAX maps are NHWC, the port's NCHW)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoflex_tpu.ops import image_ops as J
from monoflex_tpu_torch.ops import image_ops as P

B, C, H, W = 2, 3, 12, 20


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_sigmoid_hm_clamps():
    x = np.random.RandomState(0).randn(B, H, W, C).astype(np.float32) * 20
    np.testing.assert_allclose(nhwc(P.sigmoid_hm(nchw(x))), np.asarray(J.sigmoid_hm(jnp.asarray(x))),
                               atol=1e-7)


def test_nms_hm_keeps_local_maxima_at_the_border():
    """All-negative map: a zero-padded max-pool would suppress every border
    maximum, the -inf padding of both versions keeps them."""
    x = -1 - np.random.RandomState(1).rand(B, H, W, C).astype(np.float32)
    got = nhwc(P.nms_hm(nchw(x)))
    np.testing.assert_array_equal(got, np.asarray(J.nms_hm(jnp.asarray(x))))
    assert (got[:, 0] < 0).any()


def test_select_topk_matches_on_distinct_scores():
    rng = np.random.RandomState(2)
    x = rng.permutation(np.linspace(0, 1, B * H * W * C)).reshape(B, H, W, C).astype(np.float32)
    for got, want in zip(P.select_topk(nchw(x), 25), J.select_topk(jnp.asarray(x), 25)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("index_kind", ["flat", "xy"])
def test_select_point_of_interest(index_kind):
    rng = np.random.RandomState(3)
    maps = [rng.randn(B, H, W, c).astype(np.float32) for c in (4, 1, 7)]
    if index_kind == "flat":
        index = rng.randint(-3, H * W + 3, (B, 9)).astype(np.int32)   # clamped at both ends
    else:
        index = np.stack([rng.randint(0, W, (B, 9)), rng.randint(0, H, (B, 9))], -1).astype(np.int32)
    got = P.select_point_of_interest([nchw(m) for m in maps], torch.from_numpy(index))
    want = J.select_point_of_interest([jnp.asarray(m) for m in maps], jnp.asarray(index))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_add_edge_accumulates_duplicates_and_masks():
    rng = np.random.RandomState(4)
    out = rng.randn(B, H, W, C).astype(np.float32)
    E = 30
    idx = np.stack([rng.randint(0, 3, (B, E)), rng.randint(0, 2, (B, E))], -1).astype(np.int32)
    vals = rng.randn(B, E, C).astype(np.float32)
    edge_len = np.array([E - 5, 11], np.int32)
    dense = nchw(out)
    got = P.scatter_add_edge(dense, torch.from_numpy(idx), torch.from_numpy(vals),
                             torch.from_numpy(edge_len))
    want = J.scatter_add_edge(jnp.asarray(out), jnp.asarray(idx), jnp.asarray(vals),
                              jnp.asarray(edge_len))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(nhwc(dense), out)   # the input is left as it was
