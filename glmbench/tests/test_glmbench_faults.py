"""The comparison that decides ``correct`` fails where it has to: for the
control (the program's float32 path in place of its float64 one) and for
each fault a one-card cell can have, planted in the timed path underneath
a whole run on the CPU.  (No cell crosses cards, so no exchange between
cards can be left out.)"""

import pytest
import torch

import tabmat_torch
import tabmat_torch.glm
from _cpu_run import BENCH, CELLS, cpu_run
from glmbench import spec
from tabmat_torch.models.split import SplitMatrix
from tabmat_torch.parallel.design import DeviceDesign

FIT_CELLS = [c for c in CELLS if spec.find(c, bench=BENCH)["mix"]["loop"] != "ops"]
OPS_CELLS = [c for c in CELLS if spec.find(c, bench=BENCH)["mix"]["loop"] == "ops"]


def _half_rows(x):
    """The first half of the rows, doubled: the mean over half the batch."""
    keep = torch.zeros_like(x)
    keep[: x.shape[0] // 2] = 2.0
    return x * keep


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    rc, result, _ = cpu_run(cell, control=True)
    assert rc == 0 and result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_a_step_that_returns_its_state_unchanged_is_caught(cell, monkeypatch):
    monkeypatch.setattr(tabmat_torch.glm, "irls_step", lambda X, y, w, beta, **kw: beta)
    rc, result, _ = cpu_run(cell)
    assert rc == 0 and result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_left_out_is_caught(cell, monkeypatch):
    tmv, sandwich = DeviceDesign.transpose_matvec, DeviceDesign.sandwich
    monkeypatch.setattr(DeviceDesign, "transpose_matvec", lambda self, r: tmv(self, _half_rows(r)))
    monkeypatch.setattr(DeviceDesign, "sandwich", lambda self, w: sandwich(self, _half_rows(w)))
    rc, result, _ = cpu_run(cell)
    assert rc == 0 and result["correct"] is False


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_an_altered_coefficient_is_caught(cell, monkeypatch):
    fit = tabmat_torch.fit_glm

    def altered(*args, **kwargs):
        beta, n_iter = fit(*args, **kwargs)
        beta = beta.clone()
        j = int(torch.argmax(beta.abs()))
        beta[j] *= 1 + 1e-6
        return beta, n_iter

    monkeypatch.setattr(tabmat_torch, "fit_glm", altered)
    rc, result, _ = cpu_run(cell)
    assert rc == 0 and result["correct"] is False


@pytest.mark.parametrize("cell", OPS_CELLS)
def test_an_altered_sandwich_entry_is_caught(cell, monkeypatch):
    sandwich = SplitMatrix.sandwich

    def altered(self, d, rows=None, cols=None):
        S = sandwich(self, d, rows, cols).clone()
        S[0, 0] *= 1 + 1e-6
        return S

    monkeypatch.setattr(SplitMatrix, "sandwich", altered)
    rc, result, _ = cpu_run(cell)
    assert rc == 0 and result["correct"] is False
