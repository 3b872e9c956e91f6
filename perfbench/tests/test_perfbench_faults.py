"""The rest of a run with the timed path broken underneath: ``correct``
has to come out false for each fault a serving cell can have, and true
for the sound path. The cells' own limits, at tiny widths on the CPU
(the look for a card is skipped by calling the driver)."""
import copy

import pytest
import torch

from perfbench.tests import tiny

CELLS = ["dsv3.chat.c1", "jamba.docqa.c1"]


def unchanged_state(monkeypatch):
    """A decode step that returns the caches it was given, unwritten."""
    from repro_torch.models import model as M
    step = M.decode_step

    def fault(params, caches, tokens, pos, cfg, *a, **kw):
        toks, _ = step(params, copy.deepcopy(caches), tokens, pos, cfg, *a, **kw)
        return toks, caches
    monkeypatch.setattr(M, "decode_step", fault)


def half_the_batch(monkeypatch):
    """A decode step over the first half of the slots only; the second
    half is handed the first half's tokens."""
    from repro_torch.models import model as M
    step = M.decode_step

    def fault(params, caches, tokens, pos, cfg, *a, **kw):
        h = tokens.shape[0] // 2
        first = [{g: {n: x[:h] for n, x in grp.items()} for g, grp in c.items()} for c in caches]
        toks, _ = step(params, first, tokens[:h], pos[:h], cfg, *a, **kw)
        return torch.cat([toks, toks[:tokens.shape[0] - h]]), caches
    monkeypatch.setattr(M, "decode_step", fault)


def altered_token(monkeypatch):
    """Every other row's greedy token replaced by the next id."""
    from repro_torch.models.layers import common
    sample = common.greedy_sample

    def fault(logits, cfg, *a, **kw):
        t = sample(logits, cfg, *a, **kw)
        t[::2] = (t[::2] + 1) % cfg.vocab_size
        return t
    monkeypatch.setattr(common, "greedy_sample", fault)


def run(cell):
    return tiny.run(cell, seconds=5.0)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_path_is_correct(cell):
    out = run(cell)
    assert out.correct, out.checks


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch, altered_token])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out.correct, out.checks
