"""The port's contrast codings against ``tabmat_tpu``'s on the CPU.

The reference tests of ``tests/test_contrasts.py`` run here once more with
their ``tm`` replaced by the twin of ``test_torch_constructors.py``, so that
each ``from_formula`` and each ``get_model_matrix`` goes through both
packages and the results are held to each other (``toarray()`` exactly,
names, block types, ops within ``atol=1e-12``; the same exception type
where the JAX package raises).  The two tests that call ``ContrastSpec`` and
``contr`` directly run with the port's copies of them in their place, so
that the reference's expectations hold the port's codings.
"""

import pytest

from tabmat_torch.formula import contrasts

import test_contrasts  # noqa: E402
from test_torch_constructors import mirror_module, use_twin

df = test_contrasts.df
mirror_module(test_contrasts, "contrasts", globals())


@pytest.fixture(autouse=True)
def _twin(monkeypatch):
    use_twin(monkeypatch, test_contrasts)
    monkeypatch.setattr(test_contrasts, "ContrastSpec", contrasts.ContrastSpec)
    monkeypatch.setattr(test_contrasts, "contr", contrasts.contr)
