"""``tests/test_core_interleave.py``'s cases on both packages: Alg.-1
weighted interleaving (page fractions follow the weights, zero-weight
nodes get no pages, uniform weights are round robin), DWP scaling
(cluster ratios kept, the extremes), migration plans (a minimal diff,
moving toward the workers as DWP rises) and the capacity-capped water
fill. Each case runs the reference's assertions on each package
(``_torch_parity.both``) and returns the assignments, weights and plans,
which must be equal exactly. The hypothesis properties keep the
reference's ``max_examples`` and run derandomized, with no example
database."""

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _torch_parity import both  # noqa: E402


@st.composite
def weight_vectors(draw):
    n = draw(st.integers(min_value=1, max_value=12))
    w = draw(st.lists(st.floats(min_value=0.0, max_value=10.0,
                                allow_nan=False), min_size=n, max_size=n))
    if sum(w) <= 0:
        w[0] = 1.0
    return np.asarray(w)


def _settings(n):
    return settings(max_examples=n, deadline=None, derandomize=True,
                    database=None)


@given(weight_vectors(), st.integers(min_value=64, max_value=8192))
@_settings(60)
def test_alg1_fractions_match_weights(w, pages):
    def case(pkg):
        il = pkg.interleave
        wn = il.normalize(w)
        a = il.weighted_interleave(pages, wn)
        frac = il.page_fractions(a, len(wn))
        np.testing.assert_allclose(frac, wn, atol=len(wn) * 1.5 / pages
                                   + 1e-9)
        return a, frac
    both(case)


@given(weight_vectors())
@_settings(40)
def test_alg1_zero_weight_nodes_get_no_pages(w):
    def case(pkg):
        v = np.array(w)
        v[0] = 0.0
        if v.sum() <= 0:
            v[-1] = 1.0
        a = pkg.interleave.weighted_interleave(1024, v)
        assert not (a == 0).any() or v[0] > 0
        return a
    both(case)


def test_alg1_uniform_equals_round_robin():
    def case(pkg):
        il = pkg.interleave
        a = il.weighted_interleave(100, np.ones(4))
        frac = il.page_fractions(a, 4)
        np.testing.assert_allclose(frac, 0.25, atol=0.01)
        return a, frac
    both(case)


@given(weight_vectors(), st.floats(min_value=0, max_value=1))
@_settings(60)
def test_dwp_weights_preserve_cluster_ratios(w, dwp):
    def case(pkg):
        il = pkg.interleave
        wn = il.normalize(w)
        n = len(wn)
        workers = list(range(max(1, n // 2)))
        out = il.dwp_weights(wn, workers, dwp)
        assert abs(out.sum() - 1.0) < 1e-9
        wi = [i for i in workers if wn[i] > 1e-12 and out[i] > 1e-12]
        for a, b in zip(wi, wi[1:]):
            np.testing.assert_allclose(out[a] / out[b], wn[a] / wn[b],
                                       rtol=1e-6)
        nw = [i for i in range(n) if i not in workers
              and wn[i] > 1e-12 and out[i] > 1e-12]
        for a, b in zip(nw, nw[1:]):
            np.testing.assert_allclose(out[a] / out[b], wn[a] / wn[b],
                                       rtol=1e-6)
        return out
    both(case)


def test_dwp_extremes():
    def case(pkg):
        il = pkg.interleave
        w = il.normalize(np.asarray([4.0, 3, 2, 1]))
        w0 = il.dwp_weights(w, [0, 1], 0.0)
        np.testing.assert_allclose(w0, w)
        w1 = il.dwp_weights(w, [0, 1], 1.0)
        assert w1[2] == w1[3] == 0.0
        np.testing.assert_allclose(w1[:2].sum(), 1.0)
        np.testing.assert_allclose(w1[0] / w1[1], w[0] / w[1])
        return w0, w1
    both(case)


@given(weight_vectors(), st.floats(min_value=0.05, max_value=1))
@_settings(40)
def test_migration_plan_is_minimal_diff(w, dwp):
    def case(pkg):
        il = pkg.interleave
        wn = il.normalize(w)
        if len(wn) < 2:
            return None
        a0 = il.weighted_interleave(2048, il.dwp_weights(wn, [0], 0.0))
        plan = il.plan_migration(a0, il.dwp_weights(wn, [0], dwp))
        assert (plan.moves[:, 1] != plan.moves[:, 2]).all()
        untouched = np.setdiff1d(np.arange(2048), plan.moves[:, 0])
        np.testing.assert_array_equal(plan.old_assignment[untouched],
                                      plan.new_assignment[untouched])
        return plan.moves, plan.old_assignment, plan.new_assignment
    both(case)


def test_migration_moves_toward_workers_when_dwp_increases():
    def case(pkg):
        il = pkg.interleave
        w = il.normalize(np.asarray([3.0, 2.0, 1.0, 1.0]))
        a0 = il.weighted_interleave(4096, il.dwp_weights(w, [0, 1], 0.0))
        plan = il.plan_migration(a0, il.dwp_weights(w, [0, 1], 0.4))
        frac0 = il.page_fractions(plan.old_assignment, 4)[:2].sum()
        frac1 = il.page_fractions(plan.new_assignment, 4)[:2].sum()
        assert frac1 > frac0
        return plan.moves, frac0, frac1
    both(case)


def test_capacity_capped_weights_waterfill():
    def case(pkg):
        cap = pkg.interleave.capacity_capped_weights
        w = pkg.interleave.normalize(np.asarray([6.0, 3.0, 1.0]))
        out = cap(w, np.asarray([0.4, np.inf, np.inf]))
        assert out.sum() == pytest.approx(1.0)
        assert out[0] == pytest.approx(0.4)
        assert out[1] / out[2] == pytest.approx(3.0)
        out2 = cap(w, np.asarray([0.4, 0.35, np.inf]))
        assert out2 == pytest.approx([0.4, 0.35, 0.25])
        np.testing.assert_allclose(cap(w, np.full(3, np.inf)), w)
        out3 = cap(w, np.asarray([0.2, 0.2, 0.1]))
        np.testing.assert_allclose(out3, np.asarray([0.4, 0.4, 0.2]))
        out4 = cap(np.asarray([0.5, 0.5, 0.0]),
                   np.asarray([0.3, 0.3, np.inf]))
        np.testing.assert_allclose(out4, np.asarray([0.3, 0.3, 0.4]))
        return out, out2, out3, out4
    both(case)
