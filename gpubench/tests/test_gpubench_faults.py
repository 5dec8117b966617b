"""A run of a tiny twin of each cell on the CPU (the harness's look for a
card skipped), whole and with the timed path broken underneath: the check
passes the whole one and refuses each fault an image service can have (a
single card: no exchange between chips; no state kept from batch to
batch). The cells' own limits are used."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench import harness

CPU = torch.device("cpu")
CELLS = ["tiny.romp.bulk", "tiny.bev.bulk", "tiny.romp.crowd"]


def half_the_batch(service):
    """The batch's second half left out: its images get the results of
    the first half's."""
    inner = service.run_batch

    def run_batch(images):
        images = images.copy()
        h = (images.shape[0] + 1) // 2
        images[h:] = images[:h][:images.shape[0] - h]
        return inner(images)
    service.run_batch = run_batch


def an_answer_altered(service):
    """One person of each batch placed elsewhere where the results are
    produced: its vertices and joints shifted by a metre."""
    inner = service.fetch

    def fetch(handle):
        out = dict(inner(handle))
        for key in ("verts", "joints"):
            v = np.array(out[key])
            v[0, 0] += np.asarray(1.0, v.dtype)
            out[key] = v
        return out
    service.fetch = fetch


def _run(root, cell, fault=None):
    return harness.run_cell(cell, 2 ** 31 + 5, 4.0, False, CPU, root=root,
                            fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_a_whole_run_is_correct(tiny_root, cell):
    result, extra = _run(tiny_root, cell)
    assert result["correct"], extra
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [half_the_batch, an_answer_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_run_is_not_correct(tiny_root, cell, fault):
    result, extra = _run(tiny_root, cell, fault)
    assert not result["correct"], extra
