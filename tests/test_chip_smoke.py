"""chip_smoke.py off the card: it refuses a CPU platform, and each of its
phases passes at a tiny size on the CPU (the card runs them at full
width)."""
import importlib.util
import json
import os

import numpy as np
import pytest

import jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_cpu_platform(smoke, capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        smoke.main([])
    assert exc.value.code not in (0, None)
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.parametrize("prec", ["high", "highest", "default"])
def test_gram_psi_numerics_tiny(smoke, prec, capsys):
    smoke.gram_psi_numerics(T=1024, N=10, B=2, L=4, lanes=3,
                            precisions=(prec,))
    out = capsys.readouterr().out
    assert out.count(" ok") == 2 and "FAIL" not in out


def test_gram_psi_numerics_detects_error(smoke, monkeypatch):
    """A bound below f32 rounding must trip the check, so it can fail."""
    monkeypatch.setitem(smoke.BOUNDS, "highest", 1e-12)
    with pytest.raises(AssertionError, match="highest"):
        smoke.gram_psi_numerics(T=1024, N=10, B=2, L=4, lanes=3,
                                precisions=("highest",))


def test_pg_numerics_tiny(smoke, capsys):
    smoke.pg_numerics(n_unit=100_000, n_gamma=48_000)
    out = capsys.readouterr().out
    assert "pg_devroye" in out and "pg_gamma_series" in out


def test_pg_bin_check_detects_bias(smoke):
    """Draws shifted by 5% must fail the standard-error gate."""
    x = np.full(10_000, 0.25 * 1.05)        # E[PG(1, 0)] = 1/4
    with pytest.raises(AssertionError, match="z="):
        smoke._check_bin_means("shifted", x, [((1.0, 0.0),
                                                np.arange(x.size))])


def test_flagship_bernoulli_tiny(smoke, capsys):
    smoke.flagship_bernoulli(N=10, T=2000, n_burnin=2, n_samples=4)
    out = capsys.readouterr().out
    assert "precision=high" in out and "precision=default" in out


def test_flagship_nb_tiny(smoke, capsys):
    smoke.flagship_nb(N=10, T=2000, n_burnin=1, n_samples=4)
    assert "negative_binomial" in capsys.readouterr().out


def test_four_device_tiny(smoke, capsys):
    """The --four phase on four of the suite's simulated CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    smoke.four_device(N=8, T=400, n_chains=8)
    out = capsys.readouterr().out
    assert "shard placement Xf" in out and "composed mesh" in out
