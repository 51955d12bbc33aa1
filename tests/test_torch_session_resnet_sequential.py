"""The ResNet smoke's Sequential run of tests/test_torch_session.py (the
port's ``TrainSession`` on the reference engine against JAX's, float64 on
both sides, lr 3e-5, limits 1e-6 every element), trained by this module's
own fixture so that it runs on a worker beside the other runs: the state
and losses, the evaluations, and a planted fault the comparison must
reject.  tests/test_torch_session.py's docstring sets out the setup and
the limits.
"""
import pytest

from repro_torch.api import TrainSession
from test_torch_session import (BATCH, EPOCHS, ROUNDS, _configs, _reading,
                                _state_gaps, _two_threads,  # noqa: F401
                                check_evaluation, check_train_session,
                                resnet_setup, train_runs)

CASES = (("resnet", "sequential"),)


@pytest.fixture(scope="module")
def resnet():
    return resnet_setup()


@pytest.fixture(scope="module")
def trained(resnet):
    return train_runs({"resnet": resnet}, CASES)


@pytest.mark.parametrize("model,strategy", CASES)
def test_train_session_matches_jax_reference(trained, model, strategy,
                                             resnet):
    check_train_session(trained[model, strategy], model, strategy,
                        resnet["tol"])


def test_session_parity_rejects_a_planted_fault(trained, resnet):
    """The comparison above, on the port's ResNet run with the server LR
    planted 5% too large (Sequential: one shared server): the server
    trainables alone exceed the float64 limit several times over."""
    run = trained["resnet", "sequential"]
    _, (tsc, toc) = _configs("sequential", lr=resnet["lr"], x64=True)
    ts = TrainSession(resnet["port"], tsc, toc, resnet["data"], BATCH,
                      engine="reference", augment=resnet["augment"],
                      state=run["start"])
    ts.ctx.server_lr_div /= 1.05
    ts.run(ROUNDS, EPOCHS)
    gaps = _state_gaps(ts.state, run["jax_state"])
    _reading("resnet sequential, server LR 5% too large", gaps)
    assert gaps["servers"] > 5 * resnet["tol"], gaps
    assert gaps["clients"] <= resnet["tol"], gaps


@pytest.mark.parametrize("model,strategy", CASES)
def test_evaluation_matches_jax(trained, model, strategy):
    check_evaluation(trained[model, strategy], strategy)
