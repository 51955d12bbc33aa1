"""The port's MLP examples (``repro_torch/examples``, the counterparts of
``examples/quickstart.py`` and ``examples/adaptive_serving.py``) on the
CPU for 3 rounds: finite losses, the engine named, the same printed
report as the JAX package's examples, and no device taken by default
without a card."""
import re

import numpy as np
import pytest
import torch

from repro_torch.examples import adaptive_serving, quickstart


def test_quickstart_three_rounds(capsys):
    session = quickstart.main(rounds=3, log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert session.engine.name == "fused"
    assert f"engine: {session.engine_name}" in out
    assert session.round == 3
    assert [m.round for m in session.history] == [0, 1, 2]
    assert all(np.isfinite([m.client_loss, m.server_loss]).all()
               for m in session.history)
    for line in ("per-client accuracy (cut layers 1/2/3):",
                 "  client-side exits:", "  server-side      :",
                 "adaptive inference (exit iff entropy < tau):"):
        assert line in out
    assert len(re.findall(r"tau=\d\.\d  acc=\d\.\d{3}  client-ratio=",
                          out)) == 3


def test_quickstart_reference_engine_override(capsys):
    session = quickstart.main(rounds=2, engine="reference", log_every=0,
                              device="cpu")
    assert session.engine_name == "reference"
    assert "engine: reference" in capsys.readouterr().out


def test_adaptive_serving_three_rounds(capsys):
    table = adaptive_serving.main(rounds=3, device="cpu")
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == ["tau", "acc", "client%",
                                           "offloaded"]
    assert sorted(table) == [0.05, 0.2, 0.5, 1.0, 2.0]
    for acc, ratio, offloaded in table.values():
        assert 0.0 <= acc <= 1.0 and 0.0 <= ratio <= 1.0
        assert 0 <= offloaded <= 800
    # a larger threshold never exits fewer requests
    ratios = [table[t][1] for t in sorted(table)]
    assert ratios == sorted(ratios)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_examples_default_to_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(rounds=1, log_every=0)
