"""The port's regression and ranking objectives against the JAX package's.

Same seeded numpy inputs through both packages. Tolerances:

  * ``grad_hess`` of ``mse``, ``quantile`` and ``huber``: bitwise (one
    elementwise f32 op a value, in both packages);
  * ``grad_hess`` of ``lambdarank``: 1e-6 relative (sums over (N, N)
    pair matrices, taken in other orders);
  * ``init_score``: bitwise for the weighted quantile (integer
    multiplicities sum exactly in f32, whatever the order) and 1e-6
    relative for the weighted means; ``loss`` and ``metrics`` 1e-6
    relative;
  * the autodiff contract in float64: ``grad_hess[0]`` is
    ``torch.autograd.grad`` of ``loss_sum``, and where ``exact_hessian``
    ``grad_hess[1]`` is the diagonal of
    ``torch.autograd.functional.hessian`` (as tests/test_objectives.py
    holds the reference with ``jax``), to 1e-10;
  * ``make_ranking`` and ``bin_dataset(qid=)``: bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.objectives import get_objective as jget_objective
from repro.objectives import registered_objectives as jregistered
from repro.trees import losses as jlosses
from repro.trees.binning import bin_dataset as jbin_dataset
from repro_torch.convert import binned_from_numpy
from repro_torch.data import synthetic as tsyn
from repro_torch.objectives import (
    Huber,
    LambdaRank,
    Quantile,
    SquaredError,
    get_objective,
    registered_objectives,
)
from repro_torch.trees import losses as tlosses
from repro_torch.trees.binning import bin_dataset

REGRESSION = ["mse", "quantile:0.9", "huber", "huber:0.5"]
RANKING = [LambdaRank(), LambdaRank(ndcg_weight=False), LambdaRank(sigma=0.7)]
RANK_IDS = ["lambdarank", "ranknet_no_ndcg", "sigma0.7"]


def _regression_inputs(seed=0, n=300):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(n).astype(np.float32)
    f = (y + 1.5 * rng.standard_normal(n)).astype(np.float32)
    f[:7] = y[:7]  # y == f exactly: the pinball's and Huber's branch points
    w = rng.integers(1, 5, n).astype(np.float32)
    return y, f, w


def _ranking_inputs(seed=0, n_q=12, docs=10, tied=False):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n_q * docs).astype(np.float32)
    qid = np.repeat(np.arange(n_q, dtype=np.int32), docs)
    f = (np.zeros(n_q * docs) if tied else rng.standard_normal(n_q * docs)).astype(np.float32)
    if not tied:
        f[3] = f[5]  # one tie inside a query: the rank's tie-break by index
    return y, f, qid


def _both(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_registered_names_equal_the_reference():
    assert list(registered_objectives()) == list(jregistered())


@pytest.mark.parametrize("spec", ["mse", "squared_error", "quantile:0.9", "pinball", "huber",
                                  "huber:0.5", "lambdarank", "ranknet", "logistic",
                                  "multiclass:4"])
def test_specs_resolve_like_the_reference(spec):
    t, j = get_objective(spec), jget_objective(spec)
    assert type(t).__name__ == type(j).__name__ and t.name == j.name
    for flag in ("n_outputs", "exact_gradient", "exact_hessian", "rowwise"):
        assert getattr(t, flag) == getattr(j, flag), flag
    assert {k: v for k, v in vars(t).items()} == {k: v for k, v in vars(j).items()}
    assert get_objective(t) is t and hash(t) == hash(get_objective(spec))


@pytest.mark.parametrize("spec", REGRESSION)
def test_regression_objective_matches_jax(spec):
    y, f, w = _regression_inputs()
    t, j = get_objective(spec), jget_objective(spec)
    (ty, tf, tw), (jy, jf, jw) = _both(y, f, w)
    for got, want in zip(t.grad_hess(ty, tf), j.grad_hess(jy, jf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if spec.startswith("quantile"):
        np.testing.assert_array_equal(t.init_score(ty, tw).numpy(),
                                      np.asarray(j.init_score(jy, jw)))
    else:
        _close(t.init_score(ty, tw), j.init_score(jy, jw))
    _close(t.per_example(ty, tf), j.per_example(jy, jf))
    for weight in ((tw, jw), (None, None)):
        _close(t.loss(ty, tf, weight[0]), j.loss(jy, jf, weight[1]))
    tm, jm = t.metrics(ty, tf, tw), j.metrics(jy, jf, jw)
    assert set(tm) == set(jm)
    for key in tm:
        _close(tm[key], jm[key])
    assert t.link(tf) is tf  # the identity link serves the margin


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("weights", ["integer", "real"])
def test_quantile_init_score_is_the_reference_s(alpha, weights):
    """A stable sort of tied labels, the cumulative weight and a left-side
    search: the same label as ``jnp``'s, bitwise."""
    rng = np.random.default_rng(int(10 * alpha))
    y = rng.integers(-3, 4, 257).astype(np.float32)  # many ties
    w = (rng.integers(1, 6, 257) if weights == "integer" else rng.random(257) + 0.1)
    w = w.astype(np.float32)
    (ty, tw), (jy, jw) = _both(y, w)
    got = Quantile(alpha).init_score(ty, tw)
    want = np.asarray(jget_objective(f"quantile:{alpha}").init_score(jy, jw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == () and got.dtype == torch.float32


@pytest.mark.parametrize("obj", RANKING, ids=RANK_IDS)
@pytest.mark.parametrize("tied", [False, True], ids=["scores", "all_equal"])
def test_lambdarank_matches_jax(obj, tied):
    y, f, qid = _ranking_inputs(tied=tied)
    j = type(jget_objective("lambdarank"))(sigma=obj.sigma, ndcg_weight=obj.ndcg_weight)
    (ty, tf, tq), (jy, jf, jq) = _both(y, f, qid)
    tg, th = obj.grad_hess(ty, tf, qid=tq)
    jg, jh = j.grad_hess(jy, jf, qid=jq)
    _close(tg, jg, rtol=1e-6, atol=1e-7)
    _close(th, jh, rtol=1e-6, atol=1e-7)
    assert float(th.abs().sum()) > 0  # training starts even from all-equal scores
    w = np.ones_like(y)
    np.testing.assert_array_equal(obj.init_score(ty, torch.from_numpy(w)).numpy(),
                                  np.asarray(j.init_score(jy, jnp.asarray(w))))
    _close(obj.loss_sum(ty, tf, qid=tq), j.loss_sum(jy, jf, qid=jq))
    _close(obj.loss(ty, tf, qid=tq), j.loss(jy, jf, qid=jq))
    tm, jm = obj.metrics(ty, tf, qid=tq), j.metrics(jy, jf, qid=jq)
    assert set(tm) == set(jm) == {"loss", "pairwise_acc"}
    for key in tm:
        _close(tm[key], jm[key])


def test_lambdarank_raises_without_qid():
    y, f, _ = _ranking_inputs()
    for call in (LambdaRank().grad_hess, LambdaRank().loss):
        with pytest.raises(ValueError, match="per-sample query ids"):
            call(torch.from_numpy(y), torch.from_numpy(f))


def _autograd_inputs(obj):
    if isinstance(obj, LambdaRank):
        y, f, qid = _ranking_inputs(1, n_q=3, docs=6)
        return torch.from_numpy(y).double(), torch.from_numpy(f).double(), torch.from_numpy(qid)
    y, f, _ = _regression_inputs(1, 24)
    f[:7] += 0.25  # off the kinks, where the derivative is defined
    return torch.from_numpy(y).double(), torch.from_numpy(f).double(), None


@pytest.mark.parametrize("obj", [SquaredError(), Quantile(0.9), Huber(), Huber(0.5)] + RANKING,
                         ids=["mse", "quantile:0.9", "huber", "huber:0.5"] + RANK_IDS)
def test_gradient_and_hessian_are_autograd_s(obj):
    y, f, qid = _autograd_inputs(obj)

    def total(ff):
        return obj.loss_sum(y, ff, qid=qid)

    g, h = obj.grad_hess(y, f, qid=qid)
    ft = f.clone().requires_grad_()
    (grad,) = torch.autograd.grad(total(ft), ft)
    assert obj.exact_gradient
    torch.testing.assert_close(g, grad, rtol=0, atol=1e-10)
    if obj.exact_hessian:
        diag = torch.autograd.functional.hessian(total, f).diagonal()
        torch.testing.assert_close(h, diag, rtol=0, atol=1e-10)
    else:  # quantile's surrogate: ones where the true second derivative is 0
        assert torch.equal(h, torch.ones_like(f))


def test_mse_losses_match_jax():
    y, f, w = _regression_inputs(2)
    (ty, tf, tw), (jy, jf, jw) = _both(y, f, w)
    for got, want in zip(tlosses.mse_grad_hess(ty, tf), jlosses.mse_grad_hess(jy, jf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(tlosses.mse_loss(ty, tf, tw), jlosses.mse_loss(jy, jf, jw))
    _close(tlosses.mse_loss(ty, tf), jlosses.mse_loss(jy, jf))
    assert list(tlosses.LOSSES) == list(jlosses.LOSSES)


def test_make_ranking_equals_the_reference():
    t = tsyn.make_ranking(20, 16, 12, seed=5, device="cpu")
    j = jsyn.make_ranking(20, 16, 12, seed=5)
    for field in ("bins", "bin_edges", "labels", "multiplicity", "qid"):
        got = getattr(t, field)
        want = np.asarray(getattr(j, field))
        assert got.dtype == {"bins": torch.int32, "qid": torch.int32}.get(field, torch.float32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    assert t.n_bins == j.n_bins
    assert set(t.labels.tolist()) == {0.0, 1.0, 2.0}


def test_bin_dataset_and_conversion_keep_qid():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    y = rng.integers(0, 3, 64).astype(np.float32)
    qid = np.repeat(np.arange(8), 8).astype(np.int64)  # cast to int32 by both
    t = bin_dataset(x, y, n_bins=16, device="cpu", qid=qid)
    j = jbin_dataset(x, y, n_bins=16, qid=qid)
    np.testing.assert_array_equal(t.qid.numpy(), np.asarray(j.qid))
    assert t.qid.dtype == torch.int32
    assert bin_dataset(x, y, n_bins=16, device="cpu").qid is None
    sparse = t._replace(bins=bin_dataset(x, y, n_bins=16, device="cpu", sparse=True).bins)
    assert torch.equal(sparse.qid, t.qid)
    conv = binned_from_numpy(j.bins, j.bin_edges, j.labels, j.multiplicity, j.n_bins,
                             device="cpu", qid=j.qid)
    assert torch.equal(conv.qid, t.qid) and conv.qid.dtype == torch.int32
