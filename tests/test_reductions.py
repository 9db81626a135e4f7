"""Unit tests for the reduction/remap utilities (CPU-portable jnp code)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pybader_tpu.ops import reductions


def test_masked_min_pair_matches_numpy():
    rng = np.random.default_rng(0)
    n, k = 10000, 23
    labels = jnp.asarray(rng.integers(0, k, n), dtype=jnp.int32)
    values = jnp.asarray(rng.integers(0, 1 << 20, n), dtype=jnp.int32)
    mask = jnp.asarray(rng.random(n) < 0.3)
    mins, mmins = reductions.masked_min_pair(values, labels, mask, k)
    lab, val, m = np.asarray(labels), np.asarray(values), np.asarray(mask)
    big = np.iinfo(np.int32).max
    np.testing.assert_array_equal(
        np.asarray(mins), [val[lab == i].min() for i in range(k)])
    expect = np.array([
        val[(lab == i) & m].min() if ((lab == i) & m).any() else big
        for i in range(k)
    ])
    np.testing.assert_array_equal(np.asarray(mmins), expect)


def test_masked_min_pair_odd_length():
    rng = np.random.default_rng(1)
    n, k = 8001, 7  # odd: exercises the cols=1 degenerate reshape
    labels = jnp.asarray(rng.integers(0, k, n), dtype=jnp.int32)
    values = jnp.asarray(rng.integers(0, 1 << 20, n), dtype=jnp.int32)
    mask = jnp.asarray(rng.random(n) < 0.3)
    mins, _ = reductions.masked_min_pair(values, labels, mask, k)
    lab, val = np.asarray(labels), np.asarray(values)
    np.testing.assert_array_equal(
        np.asarray(mins), [val[lab == i].min() for i in range(k)])


def test_remap_sweep():
    rng = np.random.default_rng(2)
    n, k = 9000, 19
    labels = np.where(
        rng.random(n) < 0.1, -1, rng.integers(0, k, n)
    ).astype(np.int32)
    table = rng.permutation(k).astype(np.int32)
    out = np.asarray(
        reductions.remap_sweep(jnp.asarray(labels), jnp.asarray(table), k)
    )
    expect = np.where(labels < 0, labels, table[np.clip(labels, 0, None)])
    np.testing.assert_array_equal(out, expect)


def test_compact_indices():
    rng = np.random.default_rng(3)
    mask = rng.random(5000) < 0.05
    idx = np.asarray(reductions.compact_indices(jnp.asarray(mask), 512))
    expect = np.flatnonzero(mask)
    assert len(expect) <= 512
    np.testing.assert_array_equal(idx[: len(expect)], expect)
    assert (idx[len(expect):] == -1).all()


def test_charge_volume_sum_masked_vs_segment_path():
    """The masked-sweep fast path and segment_sum agree exactly."""
    rng = np.random.default_rng(4)
    n = 1 << 22  # at the fast-path size threshold
    labels = jnp.asarray(rng.integers(-1, 12, n), dtype=jnp.int32)
    density = jnp.asarray(rng.random(n))
    c_fast, v_fast = reductions.charge_volume_sum(density, labels, 0.5, 12)
    # force the segment path by disguising the size
    lab2 = labels[: n - 1]
    den2 = density[: n - 1]
    c_seg, v_seg = reductions.charge_volume_sum(den2, lab2, 0.5, 12)
    # compare on the common prefix via numpy recompute
    lab_h, den_h = np.asarray(labels), np.asarray(density)
    expect_c = np.array(
        [den_h[lab_h == i].sum() * 0.5 for i in range(12)]
    )
    np.testing.assert_allclose(np.asarray(c_fast), expect_c, rtol=1e-12)
    expect_v = np.array([(lab_h == i).sum() * 0.5 for i in range(12)])
    np.testing.assert_allclose(np.asarray(v_fast), expect_v, rtol=1e-12)


def _labels(rng, n, k, neg_frac=0.1, used=None):
    """Labels in [0, used) (default k) with ~neg_frac negatives; labels in
    [used, k) stay empty."""
    used = k if used is None else used
    lab = rng.integers(0, used, n).astype(np.int32)
    return np.where(rng.random(n) < neg_frac, -1, lab).astype(np.int32)


# (n, k, used): masked-sweep path (n >= 2^22, k <= 1024) and segment_sum
# path, label counts past 256 and 1024, and empty labels (used < k)
CV_CASES = [(10_000, 7, 7), (10_000, 300, 250), (6_000, 1500, 1500),
            (1 << 22, 12, 9), (1 << 22, 1100, 1100)]


@pytest.mark.parametrize("n,k,used", CV_CASES)
def test_charge_volume_sum_vs_numpy(n, k, used):
    rng = np.random.default_rng(n + k)
    lab = _labels(rng, n, k, used=used)
    rho = rng.random(n)
    charge, volume = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab), 0.25, k)
    keep = lab >= 0
    want_q = np.bincount(lab[keep], weights=rho[keep], minlength=k) * 0.25
    want_v = np.bincount(lab[keep], minlength=k) * 0.25
    np.testing.assert_allclose(np.asarray(charge), want_q, rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(volume), want_v)
    assert (np.asarray(volume)[used:] == 0).all()


@pytest.mark.parametrize("n,k,used", [(9_000, 23, 23), (8_192, 300, 280),
                                      (5_000, 1100, 1000)])
def test_masked_min_pair_vs_numpy(n, k, used):
    rng = np.random.default_rng(k)
    lab = _labels(rng, n, k, used=used)
    values = rng.permutation(n).astype(np.int32)
    mask = rng.random(n) < 0.2
    mins, mmins = reductions.masked_min_pair(
        jnp.asarray(values), jnp.asarray(lab), jnp.asarray(mask), k)
    big = np.iinfo(np.int32).max
    want = np.full(k, big)
    want_m = np.full(k, big)
    np.minimum.at(want, lab[lab >= 0], values[lab >= 0])
    sel = (lab >= 0) & mask
    np.minimum.at(want_m, lab[sel], values[sel])
    np.testing.assert_array_equal(np.asarray(mins), want)
    np.testing.assert_array_equal(np.asarray(mmins), want_m)


@pytest.mark.parametrize("k", [19, 300, 1500])
def test_remap_sweep_label_counts(k):
    """The unrolled (k <= 256) and grouped-loop sweeps both remap exactly,
    negatives preserved."""
    rng = np.random.default_rng(k)
    lab = _labels(rng, 7_000, k)
    table = rng.permutation(k).astype(np.int32)
    out = np.asarray(reductions.remap_sweep(
        jnp.asarray(lab), jnp.asarray(table), k))
    np.testing.assert_array_equal(
        out, np.where(lab < 0, lab, table[np.clip(lab, 0, None)]))


@pytest.mark.parametrize("k", [5, 2000])
def test_relabel_is_a_plain_gather(k):
    rng = np.random.default_rng(k)
    lab = _labels(rng, 4_000, k).reshape(10, 20, 20)
    swap = rng.integers(0, 9, k).astype(np.int32)
    out = np.asarray(reductions.relabel(jnp.asarray(lab), jnp.asarray(swap)))
    np.testing.assert_array_equal(
        out, np.where(lab < 0, lab, swap[np.clip(lab, 0, None)]))
    assert out.dtype == lab.dtype
