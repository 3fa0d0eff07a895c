"""DeviceGallery: the dense matmul + lax.top_k search against a numpy
cosine oracle, and padding rows that never surface."""

import numpy as np

from audio_sheet_retrieval_tpu.retrieval.gallery import DeviceGallery


def test_topk_matches_numpy_cosine_oracle():
    rng = np.random.default_rng(1)
    codes = rng.standard_normal((3000, 16)).astype(np.float32)
    ids = rng.integers(0, 9, 3000)
    queries = rng.standard_normal((7, 16)).astype(np.float32)
    d, i = DeviceGallery(codes, ids).topk(queries, 15)
    gn = codes / np.linalg.norm(codes, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    scores = qn @ gn.T
    want = np.argsort(-scores, axis=1)[:, :15]
    np.testing.assert_allclose(
        d, 1.0 - np.take_along_axis(scores, want, axis=1), atol=1e-5)
    for r in range(7):
        assert set(i[r]) == set(want[r])


def test_padding_rows_never_surface():
    """Anti-correlated queries: every real score is negative, so the zero
    padding rows would win without the validity mask."""
    rng = np.random.default_rng(2)
    codes = rng.standard_normal((10, 8)).astype(np.float32)
    gal = DeviceGallery(codes, np.arange(10), bucket=128)
    q = -codes[:3]
    d, i = gal.topk(q, 8)
    assert (i < 10).all() and (i >= 0).all()
    assert np.isfinite(d).all()
    ids, idx = gal.topk_ids(q, 8)
    assert ids.shape == (3, 8)
    np.testing.assert_array_equal(ids, idx)
