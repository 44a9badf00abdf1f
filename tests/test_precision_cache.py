"""Precision modes name explicit dot algorithms; the compile-cache helper
sets a directory only where JAX_COMPILATION_CACHE_DIR does not."""
import os

import numpy as np
import pytest

import jax
from jax import lax

import pyglm_tpu as pt
from pyglm_tpu.models.weights import dot_precision
from pyglm_tpu.utils import utils


def test_precision_modes_are_explicit():
    assert dot_precision("high") is lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    assert dot_precision("highest") is lax.Precision.HIGHEST
    assert dot_precision("default") is lax.Precision.DEFAULT


@pytest.mark.parametrize("make", [
    lambda: dot_precision("sr"),
    lambda: pt.SparseBernoulliGLM(4, B=2, L=4, precision="sr"),
])
def test_sr_precision_raises(make):
    with pytest.raises(ValueError, match="has been removed"):
        make()


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="unknown precision"):
        pt.BernoulliGLM(4, B=2, L=4, precision="fp8")


@pytest.mark.parametrize("cls", [
    pt.SparseBernoulliGLM, pt.BernoulliGLM, pt.SparseGaussianGLM,
    pt.GaussianGLM, pt.SparseNegativeBinomialGLM,
])
def test_high_precision_single_neuron(cls):
    """N=1 makes psi, the Gram statistics and the Gaussian cached Gram
    dots with one free column; "high" must compile and run them."""
    model = cls(1, B=2, L=4, seed=0, precision="high")
    model.generate(200, keep=True)
    out = model.fit_compiled(n_samples=2, n_burnin=1)
    assert np.all(np.isfinite(out["lls"]))
    assert np.isfinite(model.log_likelihood())
    assert np.all(np.isfinite(model.means[0]))


@pytest.mark.parametrize("spec,shapes,one_free", [
    ("tp,pn->tn", ((64, 9), (9, 1)), True),
    ("tz,tn->zn", ((64, 9), (64, 1)), True),
    ("tp,tq->pq", ((64, 1), (64, 1)), True),
    ("tp,pn->tn", ((64, 9), (9, 3)), False),
    # a batch dimension of 1 is not a free one
    ("btp,bpq->btq", ((1, 6, 5), (1, 5, 7)), False),
])
def test_einsum_at_algorithm_choice(spec, shapes, one_free):
    """einsum_at runs a dot with a free dimension of 1 in full f32 and every
    other dot at the mode's algorithm; both agree with float64."""
    from pyglm_tpu.models import weights
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    prec = weights._einsum_precision(spec, x.shape, y.shape, "high")
    assert prec is (lax.Precision.HIGHEST if one_free
                    else lax.DotAlgorithmPreset.BF16_BF16_F32_X3)

    @jax.jit
    def accumulate(x, y):
        # a dot fused into a loop's accumulation, as the Gram scans run it
        def body(acc, i):
            return acc + weights.einsum_at(spec, x + i, y, "high"), None
        acc0 = weights.einsum_at(spec, x, y, "high")
        return lax.scan(body, acc0, jax.numpy.arange(2.0))[0]

    got = np.asarray(accumulate(x, y), np.float64)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    want = sum(np.einsum(spec, x64 + i, y64) for i in (0.0, 0.0, 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_default(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(pt.__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert utils.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cache_dir_from_environment(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/nonexistent/sentinel")
    assert utils.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper must not set another dir
    assert jax.config.jax_compilation_cache_dir == "/nonexistent/sentinel"
